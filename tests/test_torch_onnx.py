"""The port's ONNX tooling against the JAX package's on the CPU:
``write_onnx``/``parse_onnx`` round trips, ``export_cell`` against JAX's
exporter on the same weights (the files byte-identical), ``run_graph``
against JAX's executor and against the port's own models on every
family's graph, ``load_pretrained("x.onnx")`` with and without ``cfg=``
against JAX's hub, the ONNX-loaded MOMO cells in engine modes ``fast`` and
``fused`` (the plain version) against JAX's engine, MOMO2 from ONNX with
a mel-domain ``cfg=`` through the webrtc and server steps (ROADMAP A4b),
and ``convert ... x.onnx`` through both CLIs. The same numpy inputs, made
from a seed, go through both packages."""

import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_denoising_tpu import cli as jax_cli
from audio_denoising_tpu.compat.onnx import (
    parse_onnx as jax_parse_onnx, run_graph as jax_run_graph)
from audio_denoising_tpu.compat.onnx_export import (
    export_cell as jax_export_cell, write_onnx as jax_write_onnx)
from audio_denoising_tpu.config import (
    Config as JaxConfig, ModelConfig as JaxModelConfig)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.models import build_model as jax_build_model
from audio_denoising_tpu.pipeline import (
    make_server_step as jax_make_server_step,
    make_webrtc_step as jax_make_webrtc_step,
    webrtc_init_state as jax_webrtc_init_state)
from audio_denoising_tpu.runtime.engine import StreamEngine as JaxEngine

from audio_denoising_torch import cli
from audio_denoising_torch.compat import (
    Graph, Node, export_cell, momo_config_from_onnx, onnx_params,
    params_from_jax, parse_onnx, run_graph, write_onnx)
from audio_denoising_torch.config import Config, DSPConfig, ModelConfig
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.models import MOMO2, MOMO3, build_model
from audio_denoising_torch.pipeline import (
    make_server_step, make_webrtc_step, webrtc_init_state)
from audio_denoising_torch.runtime.engine import StreamEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
SPECS = {"momo3": "momo3-4d4ea0", "gruunet2": "gruunet2-good",
         "unet4": os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz"),
         "trunet": os.path.join(REPO, "runs", "trunet-realnoise.npz")}
RAND_GEO = dict(num_compressed_bins=3, hidden_sizes=(16, 16, 16),
                kernel_sizes=(3, 3, 3), strides=(2, 2, 2),
                paddings=(1, 0, 1))          # tests/test_torch_momo.py's
ATOL = 1e-5       # a cell step against JAX (measured <= 2.4e-7)
NET_REL = 2e-6    # a whole network, of its output's scale (measured 9e-7)
OUT_ATOL = 2e-4   # a hop's output (tests/test_torch_fast.py)
SNR_DB = 40.0     # tests/test_torch_webrtc.py's bound on a GL waveform


def _momo2():
    """The port's MOMO2 on the golden's random weights."""
    g = np.load(os.path.join(GOLD, "model_MOMO2-rand.npz"))
    params = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    return build_model(ModelConfig(arch="MOMO2", **RAND_GEO)).load_params(
        params_from_jax(params)), params


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Each family's graph written by both exporters: name -> (port
    path, JAX path, port model)."""
    d = tmp_path_factory.mktemp("onnx")
    out = {}
    for name, spec in SPECS.items():
        _, model = load_pretrained(spec)
        _, jmodel, jparams = jax_load_pretrained(spec)
        out[name] = (export_cell(model, str(d / f"{name}.port.onnx")),
                     jax_export_cell(jmodel, jparams,
                                     str(d / f"{name}.jax.onnx")), model)
    model, params = _momo2()
    jmodel = jax_build_model(JaxModelConfig(arch="MOMO2", **RAND_GEO))
    out["momo2"] = (export_cell(model, str(d / "momo2.port.onnx")),
                    jax_export_cell(jmodel, {k: jnp.asarray(v) for k, v in
                                             params.items()},
                                    str(d / "momo2.jax.onnx")), model)
    return out


# -- the wire format ---------------------------------------------------------

def _toy_graph():
    """Every attribute kind the writer encodes: ints, floats, a string, a
    tensor, int and float lists, negative ints; initializers of several
    dtypes."""
    nodes = [Node("Conv", "/c", ("x", "w", "b"), ("y",),
                  {"strides": [2], "pads": [1, 1], "kernel_shape": [3],
                   "group": 1}),
             Node("Constant", "/k", (), ("k",),
                  {"value": np.arange(6, dtype=np.int64).reshape(2, 3)}),
             Node("Cast", "/t", ("y",), ("z",),
                  {"to": 1, "alpha": 0.25, "mode": "up",
                   "scales": [0.5, 2.0], "axes": [-1, 3]})]
    inits = {"w": np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 2, 3),
             "b": np.array([1, -2, 3, -4], np.float32),
             "i": np.array([-5, 7], np.int64),
             "u": np.array([1, 2], np.uint8)}
    return Graph(nodes, inits, [("x", (1, 2, 9))], ["z"])


def test_write_and_parse_round_trip(tmp_path):
    """The port's writer and reader against JAX's: the same bytes, the
    same parsed graph; a parsed graph written again is the same file."""
    g = _toy_graph()
    ours = write_onnx(g, str(tmp_path / "port.onnx"),
                      output_shapes={"z": (1, 4, 5)})
    theirs = jax_write_onnx(g, str(tmp_path / "jax.onnx"),
                            output_shapes={"z": (1, 4, 5)})
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = parse_onnx(ours), jax_parse_onnx(ours)
    assert got.inputs == want.inputs == [("x", (1, 2, 9))]
    assert got.outputs == want.outputs == ["z"]
    for n, jn in zip(got.nodes, want.nodes):
        assert n.op_type == jn.op_type and n.inputs == jn.inputs
        assert n.attrs.keys() == jn.attrs.keys()
        for k, v in n.attrs.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(jn.attrs[k]))
    for k, v in g.initializers.items():
        assert got.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.initializers[k], v)
    again = write_onnx(got, str(tmp_path / "again.onnx"),
                       output_shapes={"z": (1, 4, 5)})
    with open(ours, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["momo3", "gruunet2", "unet4", "trunet",
                                  "momo2"])
def test_export_cell_writes_jax_bytes(graphs, name):
    """On the same weights the port's exporter writes the file JAX's
    does, byte for byte (MOMO3 and GRUUNet2 from checkpoints/, the U-Net
    and TRUNet from runs/, MOMO2 on the golden's weights)."""
    ours, theirs, _ = graphs[name]
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def _feeds(g, batch, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(s[1:])).astype(
        np.float32) for n, s in g.inputs}


def _batched(g, batch):
    """The cell graph's batch-1 smearing fields, which a Concat joins to
    the streams' tensors, tiled to ``batch`` (ONNX's Concat broadcasts
    nothing; chip_smoke.py's ``batched_graph``)."""
    joined = {i for n in g.nodes if n.op_type == "Concat" for i in n.inputs}
    return g._replace(initializers={
        k: np.repeat(v, batch, axis=0) if k in joined and v.shape[0] == 1
        else v for k, v in g.initializers.items()})


def _model_out(model, feeds):
    """The port model's own forward on a graph's feeds."""
    with torch.no_grad():
        x = torch.from_numpy(feeds["input"])
        if "h0" in feeds:
            h = torch.from_numpy(feeds["h0"])
            carry = (h, torch.from_numpy(feeds["prev"])) if "prev" in feeds \
                else h
            y, carry = model.cell(x, carry)
            return {"output": y,
                    "hx": carry[0] if isinstance(carry, tuple) else carry}
        run = getattr(model, "forward_frames", model.apply)
        return {"output": run(x)}


@pytest.mark.parametrize("name", ["momo3", "gruunet2", "unet4", "trunet",
                                  "momo2"])
def test_run_graph_matches_jax_and_the_model(graphs, name):
    """The port's executor against JAX's on each graph at batch 1 (cells
    within ATOL, networks within NET_REL of their scale), and bit for bit
    against the port's model it was exported from; the cells also at a
    batch of 3, against JAX's executor and the model, with the batch-1
    smearing fields tiled (ONNX's Concat, and JAX's, broadcasts nothing:
    the graph as exported raises at a batch of 3)."""
    path, _, model = graphs[name]
    g = parse_onnx(path)
    feeds = _feeds(g, 1, 3)
    got, want = run_graph(g, feeds, "cpu"), jax_run_graph(g, feeds)
    assert set(got) == set(want) == set(g.outputs)
    for k in g.outputs:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        scale = float(np.abs(want[k]).max())
        tol = ATOL if "h0" in feeds else NET_REL * scale
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=tol)
    mine = _model_out(model, feeds)
    for k in g.outputs:
        assert torch.equal(got[k], mine[k])
    if "h0" in feeds:
        feeds = _feeds(g, 3, 4)
        with pytest.raises(RuntimeError):
            run_graph(g, feeds, "cpu")
        g3 = _batched(g, 3)
        got, mine = run_graph(g3, feeds, "cpu"), _model_out(model, feeds)
        want = jax_run_graph(g3, feeds)
        for k in g.outputs:
            assert torch.equal(got[k], mine[k])
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL)


# -- the hub -----------------------------------------------------------------

def test_momo2_graph_loads_as_jax_loads_it(graphs, capsys):
    """No cfg: the assumed MOMO raw front-end at the graph's 22 bins, said
    on stderr as JAX's hub says it, the same config and parameters."""
    path = graphs["momo2"][0]
    cfg, model = load_pretrained(path)
    said = capsys.readouterr().err
    jcfg, _, jparams = jax_load_pretrained(path)
    assert said == capsys.readouterr().err != ""
    assert cfg.to_json() == jcfg.to_json()
    assert (cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.dsp.domain) == \
        (42, 21, "raw")
    assert isinstance(model, MOMO2) and not model.delta
    sd = model.state_dict()
    assert set(sd) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v))
    mc, bins = momo_config_from_onnx(parse_onnx(path))
    assert bins == 22 and mc == cfg.model


def test_momo3_graph_loads_as_the_checkpoint(graphs):
    """A graph with a ``prev`` input is MOMO3's delta cell: the preset's
    model config and DSP (the assumed front-end is MOMO3's own), the
    checkpoint's parameters bit for bit. JAX's hub reads every graph as
    MOMO2: it takes this one's first conv for 7 smearing channels and
    drops ``prev`` (ROADMAP C)."""
    path = graphs["momo3"][0]
    cfg, model = load_pretrained(path)
    pcfg, pmodel = load_pretrained("momo3-4d4ea0")
    assert isinstance(model, MOMO3) and model.delta
    assert cfg.model == pcfg.model and cfg.dsp == pcfg.dsp
    params = onnx_params(parse_onnx(path))
    assert set(params) == set(pmodel.state_dict())
    for k, v in pmodel.state_dict().items():
        assert torch.equal(model.state_dict()[k], v) and torch.equal(
            params[k], v)
    jcfg, _, _ = jax_load_pretrained(path)
    assert (jcfg.model.arch, jcfg.model.num_gaussians) == ("MOMO2", 7)


def test_cfg_overrides_the_assumed_front_end(graphs):
    """``cfg=`` is served with the graph's model config in place of its
    own, in both hubs alike."""
    path = graphs["momo2"][0]
    d = dict(sample_rate=16000, n_fft=64, hop_length=32, n_mels=22)
    cfg, model = load_pretrained(path, cfg=Config(dsp=DSPConfig(**d)))
    jcfg, _, _ = jax_load_pretrained(
        path, cfg=JaxConfig.from_json(Config(dsp=DSPConfig(**d)).to_json()))
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.dsp.n_fft == 64 and cfg.model.arch == "MOMO2"
    assert model.num_bins == 22


def test_other_families_graphs_are_refused(graphs):
    """A GRUUNet2 cell, a U-Net or TRUNet graph is not a MOMO cell: the
    hub refuses it rather than build another model from it."""
    for name in ("gruunet2", "unet4", "trunet"):
        with pytest.raises(NotImplementedError, match="not a MOMO cell"):
            load_pretrained(graphs[name][0])


def _ticks(engines, hop, n, seed):
    """``n`` ticks of two streams, ``b`` missing every third tick, through
    each engine: {stream: [outputs]} per engine."""
    rng = np.random.default_rng(seed)
    outs = [{"a": [], "b": []} for _ in engines]
    for e in engines:
        e.add_stream("a")
        e.add_stream("b")
    for t in range(n):
        chunks = {s: (0.1 * rng.standard_normal(hop)).astype(np.float32)
                  for s in "ab" if not (s == "b" and t % 3 == 1)}
        for e, o in zip(engines, outs):
            for s, y in e.process(chunks).items():
                o[s].append(np.asarray(y))
    return outs


@pytest.mark.parametrize("name", ["momo3", "momo2"])
@pytest.mark.parametrize("mode", ["fast", "fused"])
def test_onnx_models_serve_as_jax_engine(graphs, name, mode):
    """The ONNX-loaded cell in StreamEngine (mode fused: the fused hop's
    plain version) against JAX's engine on the same weights and config
    (MOMO3: JAX's on the checkpoint, as its hub misreads the graph; its
    fused hop in interpret mode), a few ticks with a stream skipping."""
    path = graphs[name][0]
    cfg, model = load_pretrained(path)
    jcfg = JaxConfig.from_json(cfg.to_json())
    if name == "momo3":
        _, jmodel, jparams = jax_load_pretrained("momo3-4d4ea0")
    else:
        _, jmodel, jparams = jax_load_pretrained(path)
    eng = StreamEngine(cfg, model, mode=mode, max_streams=3, device="cpu")
    jeng = JaxEngine(jcfg, jmodel, jparams, mode=mode, max_streams=3,
                     pallas_interpret=True)
    assert eng.mode == mode
    got, want = _ticks((eng, jeng), cfg.dsp.hop_length, 8, 17)
    for s in "ab":
        np.testing.assert_allclose(np.concatenate(got[s]),
                                   np.concatenate(want[s]), atol=OUT_ATOL)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * math.log10((ref ** 2).sum()
                           / max(((ref - got) ** 2).sum(), 1e-30))


def test_momo2_from_onnx_serves_the_mel_steps_as_jax(graphs):
    """ROADMAP A4b's reach through ONNX: MOMO2 from an exported graph with
    a mel-domain ``cfg=`` (16 kHz, n_fft 256, 22 mels), a configuration
    JAX serves, through the webrtc step (GL-4: each output within
    SNR_DB of JAX's) and the server step (output within OUT_ATOL, hx
    within ATOL) against JAX's, the state carried."""
    path = graphs["momo2"][0]
    d = dict(sample_rate=16000, n_fft=256, hop_length=128, n_mels=22,
             domain="mel", reconstruction="griffin_lim", griffin_lim_iters=4)
    cfg, model = load_pretrained(path, cfg=Config(dsp=DSPConfig(**d)))
    jcfg, jmodel, jparams = jax_load_pretrained(
        path, cfg=JaxConfig.from_json(Config(dsp=DSPConfig(**d)).to_json()))
    B, rng = 2, np.random.default_rng(9)
    step, jstep = make_webrtc_step(cfg, model, "cpu"), jax.jit(
        jax_make_webrtc_step(jcfg, jmodel))
    s, js = webrtc_init_state(cfg, model, B), jax_webrtc_init_state(
        jcfg, jmodel, B)
    outs, jouts = [], []
    for _ in range(6):
        c = (0.1 * rng.standard_normal((B, 128))).astype(np.float32)
        s, out = step(s, torch.from_numpy(c))
        js, jout = jstep(jparams, js, jnp.asarray(c))
        outs.append(out.numpy())
        jouts.append(np.asarray(jout))
    assert _snr(np.concatenate(jouts[1:]), np.concatenate(outs[1:])) >= SNR_DB
    step, jstep = make_server_step(cfg, model, "cpu"), jax.jit(
        jax_make_server_step(jcfg, jmodel))
    hx, jhx = model.init_state(B), jmodel.init_state(B)
    for length in (4800, 512, 4800):
        c = (0.1 * rng.standard_normal((B, length))).astype(np.float32)
        hx, y = step(hx, torch.from_numpy(c))
        jhx, jy = jstep(jparams, jhx, jnp.asarray(c))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=OUT_ATOL)
        np.testing.assert_allclose(hx.numpy(), np.asarray(jhx), atol=ATOL)


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("src", ["momo3-4d4ea0", "gruunet2-stream16k",
                                 "trunet.npz"])
def test_convert_to_onnx_writes_what_jax_writes(src, tmp_path, capsys):
    """``convert SRC out.onnx`` through both CLIs: the same bytes."""
    src = SPECS["trunet"] if src == "trunet.npz" else src
    ours, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    assert cli.main(["convert", src, ours]) == 0
    assert jax_cli.main(["convert", src, theirs]) == 0
    assert capsys.readouterr().out == f"wrote {ours}\nwrote {theirs}\n"
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_denoise_file_serves_a_momo_graph(graphs, tmp_path):
    """``denoise --model x.onnx`` (``apps.offline.denoise_file``) on the
    MOMO2 graph, as JAX's command serves it: the same WAV within one
    LSB."""
    from audio_denoising_tpu.apps import offline as jax_offline
    from audio_denoising_tpu.io.wavio import read_wav as jax_read_wav
    from audio_denoising_torch.apps import offline
    from audio_denoising_torch.io.wavio import read_wav, write_wav
    src = str(tmp_path / "in.wav")
    write_wav(src, (0.2 * np.random.default_rng(4).standard_normal(
        4800)).astype(np.float32), 48000)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    path = graphs["momo2"][0]
    offline.denoise_file(path, src, a, device="cpu")
    jax_offline.denoise_file(path, src, b)
    got, want = read_wav(a)[0], jax_read_wav(b)[0]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1 / 32768 + 1e-9

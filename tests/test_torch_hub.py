"""The port's checkpoint surface against the JAX package's, on the CPU:
the restricted ``.pth`` reader, ``hub.load_pretrained`` on the shipped
config-less ``.npz`` checkpoints and on a reference ``.pth``, and the CLI
tools ``info``, ``models`` and ``convert``.

The reference's ``.pth`` checkpoints are not in the repo; the fixture
writes one in the reference's dict format (``arch``, ``config``,
``model_state_dict``, ``loss_record``, ``total_training_iters``) with
``torch.save`` from ``checkpoints/gruunet2-good.npz``."""

import json
import os
import pickle
import zipfile
from collections import OrderedDict

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_denoising_tpu import cli as jax_cli
from audio_denoising_tpu.compat import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
    load_torch_pickle as jax_load_torch_pickle)
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained

from audio_denoising_torch import cli
from audio_denoising_torch.compat import (
    load_params_npz, load_torch_checkpoint, load_torch_pickle)
from audio_denoising_torch.hub import load_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
SHIPPED = sorted(f for f in os.listdir(CKPT) if f.endswith(".npz"))
OUT_ATOL = 2e-4      # tests/test_fused_hop.py's bound on a hop's output


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """gruunet2-good's weights as a reference checkpoint.pth."""
    params, meta = load_params_npz(os.path.join(CKPT, "gruunet2-good.npz"))
    path = str(tmp_path_factory.mktemp("pth") / "checkpoint.pth")
    torch.save({
        "arch": meta["arch"], "config": meta["config"],
        "model_state_dict": OrderedDict(
            (k, torch.from_numpy(v.copy())) for k, v in params.items()),
        "loss_record": {"train": {0: 1.68, 100: 0.71, 200: 0.43},
                        "test": {0: 1.2, 200: 0.5}},
        "total_training_iters": meta["total_training_iters"]}, path)
    return path


def test_shipped_checkpoints_carry_no_full_config():
    """What the hub's assumed-DSP branch is for: all four shipped
    checkpoints carry only the model's hyperparameters."""
    assert len(SHIPPED) == 4
    for name in SHIPPED:
        _, meta = load_params_npz(os.path.join(CKPT, name))
        assert "full_config" not in meta and {"arch", "config"} <= set(meta)


def test_pth_reader_equals_torch_load_and_jax(pth):
    """The restricted reader gives, bit for bit, the tensors torch.load
    gives and the dict JAX's reader gives."""
    got = load_torch_checkpoint(pth)
    want = jax_load_torch_checkpoint(pth)
    ref = torch.load(pth, weights_only=False)
    assert set(got) == set(want) == set(ref) | {"model_state_dict"}
    sd = got["model_state_dict"]
    assert list(sd) == list(want["model_state_dict"]) == \
        list(ref["model_state_dict"])
    assert len(sd) == 21
    for k, v in sd.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want["model_state_dict"][k])
        np.testing.assert_array_equal(v, ref["model_state_dict"][k].numpy())
    for k in ("arch", "config", "loss_record", "total_training_iters"):
        assert got[k] == want[k] == ref[k]


def _crafted(tmp_path, module, name):
    """A torch.save-shaped archive whose pickle calls ``module.name``."""
    payload = f"c{module}\n{name}\n(S'true'\ntR.".encode()
    path = tmp_path / "evil.pth"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", payload)
    return str(path)


@pytest.mark.parametrize("module,name", [
    ("os", "system"), ("builtins", "eval"), ("numpy", "fromfile"),
    ("torch", "load")])
def test_pth_reader_refuses_other_globals(tmp_path, module, name):
    """A crafted pickle that names any global outside the whitelist is
    refused before the global is looked up, as JAX's reader refuses it."""
    path = _crafted(tmp_path, module, name)
    for reader in (load_torch_pickle, jax_load_torch_pickle):
        with pytest.raises(pickle.UnpicklingError, match="blocked"):
            reader(path)


def _frames(n_mels, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((2, 5, n_mels))).astype(np.float32)


@pytest.mark.parametrize("name", SHIPPED + ["checkpoint.pth"])
def test_load_pretrained_by_path_matches_jax(name, pth, capsys):
    """Each shipped .npz by path, and the reference .pth: the same config
    as JAX's hub (its assumed socket-path DSP), the same stderr line, and
    the model's outputs and state within OUT_ATOL of JAX's model.apply."""
    path = pth if name.endswith(".pth") else os.path.join(CKPT, name)
    cfg, model = load_pretrained(path)
    said = capsys.readouterr().err
    jcfg, jmodel, jparams = jax_load_pretrained(path)
    assert capsys.readouterr().err == said
    assert said.startswith(f"[hub] {path}: no DSP config embedded")
    assert cfg.to_json() == jcfg.to_json()
    assert (cfg.dsp.n_fft, cfg.dsp.hop_length) == (1024, 512)
    x = _frames(cfg.dsp.n_mels, 3)
    with torch.no_grad():
        y, hx = model.apply(torch.from_numpy(x))
    jy, jhx = jmodel.apply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=OUT_ATOL)
    np.testing.assert_allclose(hx.numpy().reshape(2, -1),
                               np.asarray(jhx).reshape(2, -1), atol=OUT_ATOL)


def test_presets_keep_their_own_config(capsys):
    """A preset name is served with its preset's DSP (no assumption, no
    stderr line), as in JAX's hub."""
    cfg, _ = load_pretrained("gruunet2-stream16k")
    jcfg, _, _ = jax_load_pretrained("gruunet2-stream16k")
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.dsp.n_fft == 640
    assert capsys.readouterr().err == ""


# the first case's id is from when every .onnx was refused (A14): the hub
# serves MOMO cell graphs now (tests/test_torch_onnx.py), and the case
# checks the graphs it still refuses, a GRUUNet2 cell export
@pytest.mark.parametrize("spec,err,match", [
    pytest.param("model.onnx", NotImplementedError, "not a MOMO cell graph",
                 id="model.onnx-NotImplementedError-A14"),
    ("not-a-preset", ValueError, "unknown model spec")])
def test_load_pretrained_refuses(spec, err, match, tmp_path):
    if spec.endswith(".onnx"):
        from audio_denoising_torch.compat import export_cell
        spec = export_cell(load_pretrained("gruunet2-good")[1],
                           str(tmp_path / spec))
    with pytest.raises(err, match=match):
        load_pretrained(spec)


def _printed(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("what", ["gruunet2-good.npz", "momo3-4d4ea0.npz",
                                  "checkpoint.pth"])
def test_info_prints_what_jax_prints(what, pth, capsys):
    path = pth if what.endswith(".pth") else os.path.join(CKPT, what)
    got = _printed(cli.main, ["info", path], capsys)
    want = _printed(jax_cli.main, ["info", path], capsys)
    assert got == want
    meta = json.loads(got)
    assert meta["n_params"] > 9000
    if what.endswith(".pth"):
        assert meta["train_loss_min"] < meta["train_loss_first"]


def test_models_prints_what_jax_prints(capsys):
    got = _printed(cli.main, ["models"], capsys)
    assert got == _printed(jax_cli.main, ["models"], capsys)
    rows = json.loads(got)
    assert rows["gruunet2-stream16k"]["weights"] is True


@pytest.mark.parametrize("src", ["checkpoint.pth", "gruunet2-stream16k",
                                 "momo3-4d4ea0", "gruunet2-good.npz"])
def test_convert_writes_what_jax_writes(src, pth, tmp_path, capsys):
    """``convert`` from a .pth, a preset name or an .npz: the parameters
    bit for bit and the meta JSON equal to what JAX's command writes."""
    src = {"checkpoint.pth": pth,
           "gruunet2-good.npz": os.path.join(CKPT, "gruunet2-good.npz")
           }.get(src, src)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    printed = _printed(cli.main, ["convert", src, ours], capsys)
    assert printed.startswith(f"wrote {ours} (")
    _printed(jax_cli.main, ["convert", src, theirs], capsys)
    (p, meta), (jp, jmeta) = load_params_npz(ours), load_params_npz(theirs)
    assert meta == jmeta
    assert list(p) == list(jp)
    for k in p:
        assert p[k].dtype == jp[k].dtype
        np.testing.assert_array_equal(p[k], jp[k])
    # what convert wrote loads in both hubs to the same config
    cfg, _ = load_pretrained(ours)
    jcfg, _, _ = jax_load_pretrained(theirs)
    assert cfg.to_json() == jcfg.to_json()


def test_convert_refuses_onnx(capsys, tmp_path):
    """Refused (naming A14) until the exporter was ported: ``convert
    gruunet2-good cell.onnx`` now writes the bytes JAX's command writes."""
    ours, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    assert _printed(cli.main, ["convert", "gruunet2-good", ours],
                    capsys) == f"wrote {ours}\n"
    _printed(jax_cli.main, ["convert", "gruunet2-good", theirs], capsys)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


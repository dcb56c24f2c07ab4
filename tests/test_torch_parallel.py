"""The port's in-process mesh (audio_denoising_torch/parallel/mesh.py),
its sharded fused hop (ops/kernels/fused_hop.py make_fused_hop_sharded)
and StreamEngine(mesh=...) against the JAX package's on the CPU: JAX's
side on its 8 virtual CPU devices with its kernels in interpret mode,
the port's over meshes of 8 and 2 ``cpu`` entries, each also against the
port's unsharded version, bit for bit. Every shard holds 8 rows or more:
on the CPU, MKL's sgemm can round a product of a few rows otherwise than
the same rows inside a larger product (4.7e-7 on the fp32 hop's output
at 2 rows against 16, 1.7e-7 at 4 rows against 32), which is the CPU's
BLAS and not the sharding; from 8 rows up the plain version's outputs
did not depend on the batch. Then the engine daemon's
``--multichip`` on one device and the device normalisation of the kernel
wrappers (a bare ``cuda`` launches on the current card)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import audio_denoising_tpu.ops.pallas.fused_hop as jax_fused_hop
from audio_denoising_tpu.hub import load_pretrained as jax_load_pretrained
from audio_denoising_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh, shard_engine_step as jax_shard_engine_step,
    shard_pytree_batch as jax_shard_pytree_batch)
from audio_denoising_tpu.runtime.engine import (
    StreamEngine as JaxEngine, fast_init_state as jax_fast_init_state,
    make_fast_step as jax_make_fast_step)
from audio_denoising_tpu.runtime.plan import (
    build_cell_plan as jax_build_cell_plan,
    build_cell_plan_momo as jax_build_cell_plan_momo)

from audio_denoising_torch import device as device_mod
from audio_denoising_torch.apps.engine_serve import (
    EngineDaemon, daemon_from_args, parser)
from audio_denoising_torch.config import with_unet_geometry
from audio_denoising_torch.hub import load_pretrained
from audio_denoising_torch.ops.kernels.fused_hop import (
    fused_hop_init_state, make_fused_hop, make_fused_hop_sharded)
from audio_denoising_torch.parallel import (
    make_mesh, shard_engine_step, shard_pytree_batch)
from audio_denoising_torch.parallel.mesh import gather
from audio_denoising_torch.runtime.engine import (
    StreamEngine, fast_init_state, make_fast_step)
from audio_denoising_torch.runtime.plan import plan_from_numpy

import test_torch_fused_hop as fh
import test_torch_unet as tu
import test_torch_webrtc as tw


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread, so workers running side by
    side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 64               # slots: 8 per entry on the 8-entry mesh
HOPS = 4
FAST_OUT_ATOL = 2e-4     # tests/test_torch_fast.py's bounds
FAST_HX_ATOL = 1e-5


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _jax_mesh():
    return JaxMesh(np.asarray(jax.devices()), ("streams",))


def _chunks(rng, shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


# -- shard_engine_step: the fast step (test_io_runtime.py:186-210) ---------

@pytest.mark.parametrize("entries", [8, 2])
def test_shard_engine_step_matches_jax(entries):
    jcfg, jmodel, jparams = jax_load_pretrained("gruunet2-good")
    cfg, model = load_pretrained("gruunet2-good")
    chunk = _chunks(np.random.default_rng(0), (B, cfg.dsp.hop_length))

    jmesh = jax_make_mesh(8)
    jstep = jax_shard_engine_step(jax_make_fast_step(jcfg, jmodel), jmesh)
    jnew, jout = jstep(
        jparams, jax_shard_pytree_batch(
            jmesh, jax_fast_init_state(jcfg, jmodel, B)),
        jax_shard_pytree_batch(jmesh, jnp.asarray(chunk)))

    mesh = _cpu_mesh(entries)
    step = shard_engine_step(lambda d: make_fast_step(cfg, model, d), mesh)
    assert len(step.steps) == entries
    news, outs = step(shard_pytree_batch(mesh, fast_init_state(cfg, model, B)),
                      shard_pytree_batch(mesh, torch.from_numpy(chunk)))
    assert [o.shape[0] for o in outs] == [B // entries] * entries
    out, new = gather(outs), gather(news)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=FAST_OUT_ATOL)
    np.testing.assert_allclose(new.hx.numpy(), np.asarray(jnew.hx),
                               atol=FAST_HX_ATOL)
    # the port's unsharded step on the whole batch, bit for bit
    s1, o1 = make_fast_step(cfg, model, "cpu")(
        fast_init_state(cfg, model, B), torch.from_numpy(chunk))
    assert torch.equal(out, o1) and torch.equal(new.hx, s1.hx)


def test_sharding_helpers():
    mesh = _cpu_mesh(4)
    assert mesh.axis_names == ("streams",) and mesh.shape == {"streams": 4}
    assert not mesh.distinct_cards
    x = torch.arange(24.0).reshape(8, 3)
    shards = shard_pytree_batch(mesh, {"x": x, "none": None})
    assert [s["x"].shape for s in shards] == [(2, 3)] * 4
    assert shards[1]["none"] is None
    shards[0]["x"].add_(100.0)          # a copy: the source is untouched
    assert float(x[0, 0]) == 0.0
    with pytest.raises(ValueError, match="divide"):
        shard_pytree_batch(_cpu_mesh(3), x)
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(devices=[])


# -- make_fused_hop_sharded (test_fused_hop.py::TestShardedFusedHop) -------

# case -> (checkpoint, hops per call, compute mode, gate estimator)
HOP_CASES = {"single": (fh.SPEC, 1, None, None),
             "k-hop": (fh.SPEC, 3, None, None),
             "gated": (fh.SPEC, 1, None, "both"),
             "bf16": (fh.SPEC, 1, "bf16", None),
             "int8": (fh.SPEC, 1, "int8", None),
             "momo3": ("momo3-4d4ea0", 1, None, None)}


@pytest.fixture(scope="module")
def hop_jax_runs():
    """Each case on JAX's 8-device mesh once: (cfgs, plans, chunks per
    call, JAX's outputs per call, JAX's final state)."""
    runs = {}
    for case, (spec, K, mode, gate) in HOP_CASES.items():
        jcfg, jmodel, jparams = jax_load_pretrained(spec)
        cfg, _ = load_pretrained(spec)
        if gate:
            jcfg, cfg = fh._gated(jcfg, gate), fh._gated(cfg, gate)
        jplan = (jax_build_cell_plan_momo if hasattr(jmodel, "geo")
                 else jax_build_cell_plan)(jmodel, jparams)
        jdt = fh.REDUCED[mode][1] if mode else jnp.float32
        step = jax.jit(jax_fused_hop.make_fused_hop_sharded(
            jcfg, jplan, _jax_mesh(), interpret=True, block_b=8,
            hops_per_call=K, compute_dtype=jdt))
        hop_len = cfg.dsp.hop_length
        rng = np.random.default_rng(len(runs))
        calls = [np.stack([np.tile(fh._bursty(rng, 4, hop_len, t * K + k),
                                   (B // 4, 1)) + _chunks(rng, (B, hop_len))
                           for k in range(K)])
            for t in range(HOPS // K + (HOPS % K > 0))]
        if K == 1:
            calls = [c[0] for c in calls]
        js = jax_fused_hop.fused_hop_init_state(jcfg, jplan, B)
        jouts = []
        for c in calls:
            js, jo = step(js, jnp.asarray(c))
            jouts.append(np.asarray(jo))
        runs[case] = (cfg, plan_from_numpy(jplan), calls, jouts, js)
    return runs


@pytest.mark.parametrize("entries", [8, 2])
@pytest.mark.parametrize("case", list(HOP_CASES))
def test_fused_hop_sharded_matches_jax(hop_jax_runs, case, entries):
    cfg, plan, calls, jouts, jstate = hop_jax_runs[case]
    _, K, mode, gate = HOP_CASES[case]
    tdt = fh.REDUCED[mode][0] if mode else torch.float32
    sharded = make_fused_hop_sharded(cfg, plan, _cpu_mesh(entries),
                                     hops_per_call=K, compute_dtype=tdt)
    single = make_fused_hop(cfg, plan, "cpu", hops_per_call=K,
                            compute_dtype=tdt)
    states = sharded.split_state(fused_hop_init_state(cfg, plan, B))
    s1 = fused_hop_init_state(cfg, plan, B)
    for c, jo in zip(calls, jouts):
        chunks = torch.from_numpy(c)
        states, outs = sharded(states, sharded.split_chunks(chunks))
        out = sharded.gather(outs)
        s1, o1 = single(s1, chunks)
        assert torch.equal(out, o1)            # the unsharded hop, exactly
        if mode:
            for got, want in zip(out.reshape(-1, B, out.shape[-1]),
                                 jo.reshape(-1, B, out.shape[-1])):
                fh._close(got.numpy(), want, mode)
        else:
            np.testing.assert_allclose(
                out.numpy(), jo,
                atol=fh.GATED_OUT_ATOL if gate else fh.OUT_ATOL)
    state = gather(states)
    for name, t in s1._asdict().items():
        assert (t is None) == (getattr(state, name) is None), name
        if t is not None:
            assert torch.equal(getattr(state, name), t), name
    if mode:
        # an int8 quant step that XLA's and PyTorch's sums put on either
        # side of a tie moves hx by up to 1/127 of its row's max and is
        # carried (test_torch_fused_hop.py's REDUCED notes): here one of
        # 4352 elements, 5.7e-3 after 4 hops against the 5e-3 limit set
        # on that file's inputs; the outputs above are held each hop
        fh._reduced_state_close(state._replace(hx=None) if mode == "int8"
                                else state, jstate, mode)
    else:
        fh._assert_state_close(state, jstate)
    # one FusedHop per entry, also on a mesh that repeats its device
    assert sharded.launches == 0 and len({id(h) for h in sharded.steps}) \
        == entries


def test_fused_hop_sharded_checks_its_shards():
    cfg, model = load_pretrained(fh.SPEC)
    from audio_denoising_torch.runtime.plan import build_cell_plan
    plan = build_cell_plan(model)
    sharded = make_fused_hop_sharded(cfg, plan, _cpu_mesh(2))
    state = fused_hop_init_state(cfg, plan, 4)
    with pytest.raises(ValueError, match="2 entries"):
        sharded([state], [torch.zeros(4, cfg.dsp.hop_length)])
    with pytest.raises(ValueError, match="divide"):
        sharded.split_state(fused_hop_init_state(cfg, plan, 3))
    with pytest.raises(ValueError, match="reset to 0"):
        sharded.launches = 3


# -- StreamEngine(mesh) (test_io_runtime.py:260-305, test_fused_hop.py:
# 192-205, test_unet_pipeline.py:465-485) ------------------------------------

def _ticks(hop, n, seed):
    """n ticks: 'b' leaves at tick 3 and 'e' takes its slot, 'c' skips
    every third tick, 'a' sends a NaN/Inf chunk at tick 2."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        live = ["a", "c", "d"] + (["b"] if t < 3 else ["e"] if t > 3 else [])
        chunks = {s: (0.1 * rng.standard_normal(hop)).astype(np.float32)
                  for s in live if not (s == "c" and t % 3 == 1)}
        if t == 2:
            chunks["a"][3], chunks["a"][7] = np.nan, np.inf
        out.append(chunks)
    return out


def _engine_pair(mode, n):
    """(JAX's engine of ``n`` slots on its 8-device mesh, the port's
    config and model, a closeness check of one stream's output)."""
    if mode in ("fast", "fused"):
        spec = "gruunet2-good" if mode == "fast" else fh.SPEC
        jcfg, jmodel, jparams = jax_load_pretrained(spec)
        cfg, model = load_pretrained(spec)
        atol = FAST_OUT_ATOL if mode == "fast" else fh.OUT_ATOL
        close = lambda got, want: np.testing.assert_allclose(
            got, want, atol=atol)
    elif mode == "fused-webrtc":
        (jcfg, jmodel, jparams, _), (cfg, model, _) = tw._small(n_iter=2)
        close = lambda got, want: np.testing.assert_allclose(
            got, want, **tw.KERNEL_OUT)
    else:
        jcfg, jmodel, jparams = jax_load_pretrained(tu.UNET4)
        cfg, model = load_pretrained(tu.UNET4)
        jcfg, cfg = tu._pair(jcfg, cfg)
        close = lambda got, want: np.testing.assert_allclose(
            got, want, atol=tu.OUT_ATOL)
    jeng = JaxEngine(jcfg, jmodel, jparams, mode=mode, max_streams=n,
                     mesh=_jax_mesh(), pallas_interpret=True)
    return jeng, cfg, model, close


@pytest.fixture
def jax_small_fused_tiles(monkeypatch):
    """JAX's engine builds the sharded hop at its default 128-row tile;
    8-row tiles, as test_fused_hop.py::TestShardedFusedHop runs it,
    compute the same per stream in far less interpreter time."""
    orig = jax_fused_hop.make_fused_hop
    monkeypatch.setattr(jax_fused_hop, "make_fused_hop",
                        lambda c, p, **kw: orig(c, p, **dict(kw, block_b=8)))


def _drive(engines, ticks, snap_at):
    """Both engines through ``ticks``; a snapshot at ``snap_at`` restored
    at the end and the ticks after it replayed. -> per engine, the outputs
    of every tick and of the replay."""
    for e in engines:
        for s in "abcd":
            e.add_stream(s)
    outs, snaps = [[] for _ in engines], []
    for t, chunks in enumerate(ticks):
        if t == 3:
            for e in engines:
                e.remove_stream("b")
                e.add_stream("e")
        if t == snap_at:
            snaps = [e.snapshot() for e in engines]
        for o, e in zip(outs, engines):
            o.append(e.process(chunks))
    replays = [[] for _ in engines]
    for r, e, snap in zip(replays, engines, snaps):
        e.restore(snap)
        for chunks in ticks[snap_at:]:
            r.append(e.process(chunks))
    return outs, replays


@pytest.mark.parametrize("mode,entries", [
    ("fast", 2), ("fast", 8), ("fused", 2), ("fused", 8),
    ("fused-webrtc", 2), ("unet", 2)])
def test_engine_on_mesh_matches_jax_and_the_unsharded_engine(
        mode, entries, jax_small_fused_tiles):
    """Join and leave, a NaN/Inf chunk, a skipped tick, a snapshot
    restored and replayed; 8 slots per entry."""
    n = 8 * entries
    jeng, cfg, model, close = _engine_pair(mode, n)
    eng = StreamEngine(cfg, model, mode=mode, max_streams=n,
                       mesh=_cpu_mesh(entries))
    ref = StreamEngine(cfg, model, mode=mode, max_streams=n, device="cpu")
    assert eng.mode == ref.mode == jeng.mode == mode
    assert len(eng.shards) == entries and eng.device == torch.device("cpu")
    ticks = _ticks(cfg.dsp.hop_length, 9 if mode == "unet" else 8, 5)
    snap_at = 5
    (oj, ot, o1), (rj, rt, r1) = _drive((jeng, eng, ref), ticks, snap_at)
    assert eng.slots == jeng.slots == ref.slots
    for tj, tt, t1 in zip(oj + rj, ot + rt, o1 + r1):
        assert set(tt) == set(tj) == set(t1)
        for s in tt:
            assert np.all(np.isfinite(tt[s]))
            assert np.array_equal(tt[s], t1[s]), s
            close(tt[s], tj[s])
    for k, v in ref.snapshot()["state"].items():    # the whole batch
        assert np.array_equal(eng.snapshot()["state"][k], v), k
    assert eng.algorithmic_latency_ms == jeng.algorithmic_latency_ms


def test_engine_on_mesh_refuses_uneven_slots_and_a_device():
    cfg, model = load_pretrained("gruunet2-good")
    with pytest.raises(ValueError, match="divide evenly"):
        StreamEngine(cfg, model, mode="fast", max_streams=6,
                     mesh=_cpu_mesh(4))
    with pytest.raises(ValueError, match="device=None"):
        StreamEngine(cfg, model, mode="fast", max_streams=8, device="cpu",
                     mesh=_cpu_mesh(4))


def test_engine_on_mesh_state_setter_splits():
    cfg, model = load_pretrained("gruunet2-good")
    eng = StreamEngine(cfg, model, mode="fast", max_streams=8,
                       mesh=_cpu_mesh(4))
    state = eng.state
    eng.state = state._replace(ring=torch.ones_like(state.ring))
    assert [float(s.ring.sum()) for s in eng.shards] == \
        [2.0 * cfg.dsp.n_fft] * 4
    assert eng.process_batch(torch.zeros(8, cfg.dsp.hop_length)).shape == \
        (8, cfg.dsp.hop_length)


# -- engine --multichip -------------------------------------------------------

def test_multichip_on_one_device_serves_unsharded():
    args = parser().parse_args(["--multichip", "--device", "cpu",
                                "--max-streams", "4", "--port", "0"])
    assert args.multichip
    daemon = daemon_from_args(args)
    assert daemon.engine.mesh is None and "unsharded" in daemon.placement


def test_daemon_on_a_mesh_answers_as_the_unsharded_engine():
    """The daemon's tick over a sharded engine: one client's replies
    equal the unsharded engine's outputs on the same chunks."""
    from multiprocessing.connection import Client
    daemon = EngineDaemon("gruunet2-good", max_streams=16,
                          address=("127.0.0.1", 0), mode="fast",
                          device="cpu", mesh=_cpu_mesh(2))
    assert "2 entries" in daemon.placement and len(daemon.engine.shards) == 2
    ref = StreamEngine(daemon.cfg, daemon.model, mode="fast", max_streams=16,
                       device="cpu")
    import threading
    threading.Thread(target=daemon.serve_forever, daemon=True).start()
    assert daemon.listening.wait(30)
    hop = daemon.engine.hop
    rng = np.random.default_rng(3)
    try:
        with Client(daemon.address) as conn:
            for i in range(9):              # 's8' lands on the second shard
                conn.send(("open", f"s{i}"))
                assert conn.recv() == ("ok", f"s{i}", i)
                ref.add_stream(f"s{i}")
            for _ in range(3):
                chunk = _chunks(rng, hop)
                conn.send(("chunk", "s8", chunk))
                assert conn.poll(30)
                op, sid, out = conn.recv()
                assert op == "out" and sid == "s8"
                assert np.array_equal(out, ref.process({"s8": chunk})["s8"])
    finally:
        daemon.stop()


# -- the kernel wrappers' device (a bare cuda is the current card) ----------

def test_bare_cuda_is_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert device_mod.indexed("cuda") == torch.device("cuda", 1)
    assert device_mod.indexed(torch.device("cuda")) == torch.device("cuda", 1)
    assert device_mod.indexed("cuda:0") == torch.device("cuda", 0)
    assert device_mod.indexed("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.resolve_device(None) == torch.device("cuda", 1)
    assert device_mod.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")

"""The port's multi-process code on the CPU (audio_denoising_torch/
parallel/distributed.py, train/context.py make_sharded_train_step,
``train --data-parallel``): two gloo processes started from this file.

- ``initialize`` with an explicit rendezvous: the pair reduces 0..7 to
  28.0 over the global mesh, as tests/test_distributed.py does in JAX.
- One data-parallel step, each rank on its rows of the batch, against
  JAX's ``make_sharded_train_step`` on its 8-device mesh and against the
  port's single-device step, with tests/test_torch_train.py's
  tolerances; then a U-Net with dropout, port against port (each rank
  draws the whole batch's masks and keeps its rows).
- ``train --data-parallel --device cpu`` under a two-rank environment
  writes the checkpoint the one-device command writes.

A worker is this file run as a script (``python
tests/test_torch_distributed.py KIND STORE RANK DIR``); it imports
neither JAX nor the tests. The processes meet through a ``file://``
store in the test's temporary directory, so parallel test workers never
race for a port. JAX's side is imported inside the test that needs it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: one intra-op thread, so workers running side by
    side do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def _run_ranks(argvs, envs=None):
    """Start one process per argv, wait for all (TIMEOUT_S each), kill
    any left; -> their outputs. Fails naming a rank that exited non-0."""
    procs = [subprocess.Popen(argv, cwd=REPO, env=(envs or {}).get(i, _env()),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


def _workers(kind, tmp_path, *extra):
    store = "file://" + str(tmp_path / f"store-{kind}")
    return _run_ranks([[sys.executable, os.path.abspath(__file__), kind,
                        store, str(rank), str(tmp_path), *extra]
                       for rank in range(WORLD)])


# -- initialize (tests/test_distributed.py) ---------------------------------

def test_two_process_initialize_and_reduce(tmp_path):
    outs = _workers("reduce", tmp_path)
    for rank, out in enumerate(outs):
        assert f"DIST-OK pid={rank} sum=28.0" in out, out


def test_single_process_initialize_is_a_no_op(monkeypatch):
    from audio_denoising_torch.parallel import distributed
    for k in ("ADT_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.local_device()


# -- the data-parallel step ---------------------------------------------------

def _step_cases():
    """{case: (JAX config or None, the port's config, parameters)}: the
    small GRUUNet2 of tests/test_torch_train.py on the residual objective
    at batch 8 (JAX's mesh has 8 devices), and the trained UNet2d4 at
    dropout 0.3, batch 4."""
    import dataclasses
    import test_torch_train as tt
    jc, pc = tt._cfgs(train=dict(batch_size=8))
    jctx, _ = tt._contexts(jc, pc)
    good = {k: np.asarray(v) for k, v in jctx.state.params.items()}
    _, uc, uparams = tt._trained("unet4crop2s-mrstft-30k.npz", 4800,
                                 "residual_mse")
    uc = dataclasses.replace(
        uc, model=dataclasses.replace(uc.model, dropout=0.3),
        train=dataclasses.replace(uc.train, batch_size=4))
    return {"gruunet2": (jc, pc, good), "unet_dropout": (None, uc, uparams)}


def _port_single_step(cfg, params, mix, clean):
    """The port's single-device step: (loss, grads, params after)."""
    from audio_denoising_torch.models import build_model
    from audio_denoising_torch.train import TrainingContext
    ctx = TrainingContext(cfg, build_model(cfg.model,
                                           num_bins=cfg.dsp.n_mels),
                          params=params, device="cpu")
    loss, grads = ctx.loss_and_grads(mix, clean)
    ctx.train_step(mix, clean)
    return float(loss), grads, {k: v.detach() for k, v in
                                ctx.state.params.items()}


def test_data_parallel_step_matches_jax_and_the_single_device_step(
        tmp_path):
    import jax
    import jax.numpy as jnp
    import test_torch_train as tt
    from audio_denoising_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audio_denoising_tpu.train.context import (
        make_sharded_train_step as jax_sharded_step)
    from audio_denoising_torch.compat import save_params_npz

    cases = _step_cases()
    batches = {}
    for case, (_, pc, params) in cases.items():
        batches[case] = tt._batch(pc, seed=3)
        save_params_npz(str(tmp_path / f"{case}-init.npz"),
                        dict(params, mix=batches[case][0],
                             clean=batches[case][1]),
                        {"config": json.loads(pc.to_json())})
    _workers("step", tmp_path, ",".join(cases))

    from audio_denoising_torch.compat import load_params_npz
    for case, (jc, pc, params) in cases.items():
        mix, clean = batches[case]
        got = [load_params_npz(str(tmp_path / f"{case}-rank{r}.npz"))[0]
               for r in range(WORLD)]
        for k in params:                          # the replicas agree
            assert np.array_equal(got[0][k], got[1][k]), k
        loss = float(got[0]["__loss__"])
        dp_params = {k: got[0][k] for k in params}
        dp_grads = {k: got[0][f"__grad__{k}"] for k in params}
        lr = pc.train.learning_rate
        s_loss, s_grads, s_params = _port_single_step(pc, params, mix, clean)
        assert abs(loss - s_loss) <= tt.LOSS_RTOL * abs(s_loss)
        tt.check_grads(s_grads, dp_grads)
        tt.check_params(s_params, dp_params, lr, (s_grads, dp_grads))
        if jc is None:
            continue
        jctx, _ = tt._contexts(jc, pc, params=params)
        step = jax_sharded_step(jctx, jax_make_mesh())
        jstate, jloss = step(jctx.state, jnp.asarray(mix),
                             jnp.asarray(clean))
        _, jgrads, _ = tt._jax_step(tt._contexts(jc, pc, params=params)[0],
                                    mix, clean)
        assert abs(loss - float(jloss)) <= tt.LOSS_RTOL * abs(float(jloss))
        tt.check_grads(jgrads, dp_grads)
        tt.check_params(jstate.params, dp_params, lr, (jgrads, dp_grads))
        assert jax.device_count() == 8


# -- train --data-parallel ----------------------------------------------------

def _corpus(tmp_path):
    from audio_denoising_torch.io.wavio import write_wav
    d = tmp_path / "corpus"
    d.mkdir()
    sr = 16000
    t = np.arange(sr) / sr
    for i, f in enumerate((220, 330, 440)):
        write_wav(str(d / f"c{i}.wav"),
                  (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32), sr)
    return str(d)


def test_train_data_parallel_writes_the_single_device_checkpoint(tmp_path):
    import test_torch_train as tt
    from audio_denoising_torch.apps.trainer import main as train_main
    from audio_denoising_torch.compat import load_params_npz
    data = _corpus(tmp_path)
    args = ["train", "--preset", "gruunet2-good", "--data", data,
            "--device", "cpu", "--iters", "3", "--eval-every", "0",
            "--log-every", "1", "--batch-size", "4", "--crop-samples",
            "4096"]
    one, dp = str(tmp_path / "one.npz"), str(tmp_path / "dp.npz")
    assert train_main(args[1:] + ["--save", one]) == 0
    store = "file://" + str(tmp_path / "store-train")
    argv = [sys.executable, "-m", "audio_denoising_torch", *args,
            "--data-parallel", "--save", dp]
    outs = _run_ranks([argv] * WORLD, {r: _env(
        ADT_COORDINATOR=store, RANK=str(r), WORLD_SIZE=str(WORLD),
        LOCAL_RANK="0") for r in range(WORLD)})
    assert "data-parallel over 2 ranks" in outs[0]
    assert outs[1].strip() == ""                # rank 0 alone prints
    (p1, m1), (p2, m2) = load_params_npz(one), load_params_npz(dp)
    assert m2["total_training_iters"] == m1["total_training_iters"] == 3
    assert m2["opt_step"] == 3
    r1, r2 = (m["loss_record"]["train"] for m in (m1, m2))
    assert set(r1) == set(r2)
    for k in r1:
        assert abs(r1[k] - r2[k]) <= tt.LOSS_RTOL * abs(r1[k]) * 10, k
    lr = m1["full_config"]["train"]["learning_rate"]
    for k, v in p1.items():
        if k.startswith("__opt__"):
            continue
        # three Adam steps, each within round-off of one LR step
        assert np.abs(p2[k] - v).max() <= 3 * tt.ROUNDOFF_STEP * lr, k


# -- the workers ----------------------------------------------------------------

def _worker_reduce(store, rank, _tmp):
    import torch.distributed as dist
    from audio_denoising_torch.parallel import distributed
    assert distributed.initialize(coordinator_address=store,
                                  num_processes=WORLD, process_id=rank,
                                  device="cpu")
    assert distributed.initialize()              # idempotent
    mesh = distributed.global_mesh("streams")
    assert mesh.size() == WORLD and distributed.local_device().type == "cpu"
    part = torch.arange(8.0)[rank * 4:(rank + 1) * 4].sum()
    dist.all_reduce(part, group=mesh.get_group())
    distributed.shutdown()
    print(f"DIST-OK pid={rank} sum={float(part)}", flush=True)


def _worker_step(store, rank, tmp, cases):
    from audio_denoising_torch.compat import load_params_npz, save_params_npz
    from audio_denoising_torch.config import Config
    from audio_denoising_torch.models import build_model
    from audio_denoising_torch.parallel import distributed
    from audio_denoising_torch.train.context import (
        TrainingContext, make_sharded_train_step)
    distributed.initialize(coordinator_address=store, num_processes=WORLD,
                           process_id=rank, device="cpu")
    try:
        for case in cases.split(","):
            stored, meta = load_params_npz(os.path.join(tmp,
                                                        f"{case}-init.npz"))
            cfg = Config.from_json(json.dumps(meta["config"]))
            mix, clean = stored.pop("mix"), stored.pop("clean")
            ctx = TrainingContext(cfg, build_model(
                cfg.model, num_bins=cfg.dsp.n_mels), params=stored,
                device="cpu")
            step = make_sharded_train_step(ctx, distributed.global_mesh())
            loss = step(mix, clean)
            out = {k: v.detach().numpy() for k, v in
                   ctx.state.params.items()}
            out.update({f"__grad__{k}": v.grad.numpy()
                        for k, v in ctx.state.params.items()})
            out["__loss__"] = np.asarray(float(loss))
            save_params_npz(os.path.join(tmp, f"{case}-rank{rank}.npz"),
                            out, {})
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    kind, store, rank, tmp, *rest = sys.argv[1:]
    {"reduce": _worker_reduce, "step": _worker_step}[kind](
        store, int(rank), tmp, *rest)

"""Rules of the port: it imports neither JAX nor the JAX package, and
chip_smoke.py fails (with no result line) without a card or outside a
checkout of the repo."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "audio_denoising_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return sorted(mods)


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(extra)
    return env


def test_every_port_module_is_found():
    mods = _port_modules()
    assert "audio_denoising_torch.ops.kernels.fused_hop" in mods
    assert "audio_denoising_torch.apps.engine_serve" in mods
    assert len(mods) >= 20


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'audio_denoising_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def _assert_failed(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        env=_clean_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    _assert_failed(proc)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _clean_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    _assert_failed(proc)


def test_cli_lists_only_ported_commands():
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           "--help"], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert "engine" in proc.stdout


@pytest.mark.parametrize("argv", [["engine", "--mode", "fast"],
                                  ["no-such-command"]])
def test_cli_refuses_what_is_not_ported(argv):
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           *argv], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2

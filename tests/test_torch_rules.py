"""Rules of the port: it imports neither JAX nor the JAX package, and
chip_smoke.py fails (with no result line) without a card or outside a
checkout of the repo."""

import json
import os
import re
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
    for mod in ("apps.ws_serve", "apps.serve", "compat.torch_loader"):
        assert f"audio_denoising_torch.{mod}" in mods
    assert len(mods) >= 20


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.ops.kernels.webrtc_hop",
    "audio_denoising_torch.pipeline", "audio_denoising_torch.ops.stft",
    "audio_denoising_torch.ops.griffinlim"])
def test_webrtc_slice_modules_are_found(module):
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.ops.kernels.fused_cell",
    "audio_denoising_torch.runtime.profiler",
    "audio_denoising_torch.apps.profile_app"])
def test_fast_slice_modules_are_found(module):
    """The third slice's modules fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.ops.noisefloor",
    "audio_denoising_torch.ops.kernels.fused_hop",
    "audio_denoising_torch.runtime.engine"])
def test_gate_slice_modules_are_found(module):
    """The fourth slice's modules (the SNR gate, the K-hop fused hop)
    fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.io", "audio_denoising_torch.io.native",
    "audio_denoising_torch.io.wavio", "audio_denoising_torch.io.flac",
    "audio_denoising_torch.io.ffmpeg", "audio_denoising_torch.io.avdec",
    "audio_denoising_torch.io.codec", "audio_denoising_torch.io.cache",
    "audio_denoising_torch.io.stream", "audio_denoising_torch.io.websocket",
    "audio_denoising_torch.io.playback", "audio_denoising_torch.ops.resample",
    "audio_denoising_torch.apps.offline"])
def test_offline_slice_modules_are_found(module):
    """The tenth slice's modules (host audio I/O, the resampler, the
    offline app) fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.runtime.quant",
    "audio_denoising_torch.ops.kernels.common"])
def test_quant_slice_modules_are_found(module):
    """The eleventh slice's modules (the W8A8 plan, the reduced-precision
    cell math) fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.apps.ws_serve", "audio_denoising_torch.apps.serve",
    "audio_denoising_torch.compat.torch_loader",
    "audio_denoising_torch.hub", "audio_denoising_torch.cli"])
def test_serving_slice_modules_are_found(module):
    """The twelfth slice's modules (the daemons, the .pth reader, the hub
    and the CLI) fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.train", "audio_denoising_torch.train.context",
    "audio_denoising_torch.train.data",
    "audio_denoising_torch.train.device_data",
    "audio_denoising_torch.train.distill",
    "audio_denoising_torch.train.losses",
    "audio_denoising_torch.train.eval_metrics",
    "audio_denoising_torch.apps.trainer", "audio_denoising_torch.apps.evaluate",
    "audio_denoising_torch.apps.compare"])
def test_training_slice_modules_are_found(module):
    """The fifteenth slice's modules (training, evaluation and their
    commands) fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.parallel", "audio_denoising_torch.parallel.mesh",
    "audio_denoising_torch.parallel.distributed",
    "audio_denoising_torch.parallel.tp"])
def test_parallel_slice_modules_are_found(module):
    """The sixteenth slice's modules (the in-process mesh, the process
    group, the tensor-parallel cell) fall under the import check below."""
    assert module in _port_modules()


@pytest.mark.parametrize("module", [
    "audio_denoising_torch.compat.onnx",
    "audio_denoising_torch.compat.onnx_export",
    "audio_denoising_torch.apps.loopback",
    "audio_denoising_torch.ops.compress"])
def test_tooling_slice_modules_are_found(module):
    """The seventeenth slice's modules (the ONNX reader, executor and
    exporter, the loopback command, the spectral compression ops) fall
    under the import check below."""
    assert module in _port_modules()


def _c_fields(source, struct):
    with open(os.path.join(PKG, "csrc", source)) as f:
        text = f.read()
    body = text[text.index(f"struct {struct} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    return [re.search(r"(\w+)\s*(\[[^\]]*\])?$", decl)[1]
            for decl in (line.split("//")[0].strip().rstrip(";")
                         for line in body.splitlines()) if decl]


@pytest.mark.parametrize("struct,source,mirror", [
    ("AdtPlanScales", "plan_cell.cuh", "common.PlanScaleArgs"),
    ("AdtFusedHopArgs", "fused_hop.cu", "fused_hop._Args")])
def test_reduced_mode_mirrors_name_the_kernel_fields(struct, source, mirror):
    """The int8 plan's scale struct, field for field, and the fused hop's
    argument struct's tail (its scales and compute mode, appended after
    the fields the fp32 kernel reads) in their ctypes mirrors."""
    import importlib
    module, cls = mirror.split(".")
    mod = importlib.import_module(
        f"audio_denoising_torch.ops.kernels.{module}")
    names = [f[0] for f in getattr(mod, cls)._fields_]
    fields = _c_fields(source, struct)
    if struct == "AdtPlanScales":
        assert fields == names
    else:
        assert fields[-4:] == names[-4:] == [
            "output_gain", "state_decay", "scales", "compute"]


@pytest.mark.parametrize("source", sorted(
    f for f in os.listdir(os.path.join(PKG, "csrc"))
    if f.endswith((".cu", ".cuh"))))
def test_kernel_sources_are_hand_written(source):
    """The kernels include the CUDA runtime and their own headers only:
    no cuFFT, cuBLAS, CUTLASS or PyTorch on the kernels' path."""
    with open(os.path.join(PKG, "csrc", source)) as f:
        text = f.read()
    includes = [line.split(None, 1)[1].strip() for line in text.splitlines()
                if line.startswith("#include")]
    assert includes, source
    for inc in includes:
        assert inc == "<cuda_runtime.h>" or (
            inc.startswith('"') and inc.endswith('.cuh"')), inc
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for word in ("cufft", "cublas", "cutlass", "cute::", "at::"):
        assert word not in code.lower(), word


@pytest.mark.parametrize("struct,module", [
    ("AdtWebRTCHopArgs", "webrtc_hop"), ("AdtPlan", "common")])
def test_ctypes_mirrors_name_the_kernel_fields(struct, module):
    """The ctypes mirrors of the kernels' argument structs list the C
    fields in order (the card checks their sizes agree; this checks the
    names here, without a compiler)."""
    import importlib
    mod = importlib.import_module(
        f"audio_denoising_torch.ops.kernels.{module}")
    mirror = {"AdtWebRTCHopArgs": "_Args", "AdtPlan": "PlanArgs"}[struct]
    src = "webrtc_hop.cu" if module == "webrtc_hop" else "plan_cell.cuh"
    with open(os.path.join(PKG, "csrc", src)) as f:
        text = f.read()
    body = text[text.index(f"struct {struct} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            fields.append(re.search(r"(\w+)\s*(\[[^\]]*\])?$", decl)[1])
    assert fields == [f[0] for f in getattr(mod, mirror)._fields_]


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
    listed = proc.stdout.split("commands: ", 1)[1].strip().split(", ")
    assert sorted(listed) == ["compare", "convert", "denoise", "engine",
                              "eval", "info", "loopback", "models",
                              "profile", "serve", "train", "ws"]


@pytest.mark.parametrize("command", ["ws", "serve"])
def test_cli_daemons_without_a_card_fail_before_binding(command):
    """Without a card and without --device cpu, ws and serve exit 1 with
    the reason, before they load a model or bind a socket."""
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           command, "--port", "0"], cwd=REPO,
                          env=_clean_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert "listening" not in proc.stdout and "ws://" not in proc.stdout


def test_cli_tools_touch_no_device():
    """info, models and convert run without a card, as in JAX."""
    for argv in (["models"], ["info", "checkpoints/gruunet2-good.npz"]):
        proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                               *argv], cwd=REPO,
                              env=_clean_env(CUDA_VISIBLE_DEVICES=""),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        json.loads(proc.stdout)


def test_cli_denoise_without_a_card_writes_nothing(tmp_path):
    """Without a card and without --device cpu, denoise fails before it
    reads or writes a file."""
    import wave
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    with wave.open(str(src), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(b"\x00\x00" * 1600)
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           "denoise", str(src), str(out)], cwd=REPO,
                          env=_clean_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()


# the ids are the cases' places in the list before mode unet was served;
# argv5 was `convert ... x.onnx`, refused until the ONNX exporter was
# ported (tests/test_torch_onnx.py holds it against JAX's now)
@pytest.mark.parametrize("argv", [
    pytest.param(["profile", "--mode", "unet"], id="argv0"),
    pytest.param(["no-such-command"], id="argv2"),
    pytest.param(["loopback", "--no-denoise"], id="argv5")])
def test_cli_refuses_what_is_not_ported(argv):
    """What the port refuses as JAX does: profile has no mode unet in
    either package, and loopback needs the sounddevice package, which
    the test machines do not have."""
    proc = subprocess.run([sys.executable, "-m", "audio_denoising_torch",
                           *argv], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    item = {"loopback": "sounddevice"}.get(argv[0])
    if item:
        assert item in proc.stderr


# these three cases were refused (naming A8) until the segment family was
# ported: each daemon now starts in mode unet and says so
@pytest.mark.parametrize("argv", [["engine", "--mode", "unet"],
                                  ["ws", "--mode", "unet"],
                                  ["ws", "--mode", "unet",
                                   "--unet-seg-hops", "4"]])
def test_cli_serves_mode_unet(argv):
    """``engine``/``ws --mode unet`` on runs/unet4crop2s-mrstft-30k.npz
    with ``--device cpu --port 0``: the daemon's banner names mode unet;
    then it is stopped."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_denoising_torch", *argv, "--model",
         os.path.join(REPO, "runs", "unet4crop2s-mrstft-30k.npz"),
         "--device", "cpu", "--port", "0", "--max-streams", "2"],
        cwd=REPO, env=_clean_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    assert "mode unet" in banner, banner

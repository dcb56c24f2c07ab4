"""Live mic -> speaker loopback diagnostic (JAX counterpart
apps/loopback.py; the reference's rtmds.py:25-98: a duplex sounddevice
stream, a gain knob, device selection, its denoising path disabled).

Here the denoiser is wired in (``--model``): every block the sound card
delivers is one hop of the streaming fast step (``make_fast_step``) on
the card, or on the CPU with ``--torch-device cpu``, its state carried
from block to block. ``--no-denoise`` is the reference's raw loopback at
48 kHz and 768-sample blocks. Needs the optional ``sounddevice`` package
and audio hardware: the module imports everywhere and refuses, as the
JAX command does, only when run without them. ``--device`` is the
sounddevice device, as in the JAX command.
"""

import argparse

import numpy as np
import torch

from audio_denoising_torch.io.playback import playback_available


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="audio_denoising_torch loopback",
        description="Mic -> speaker loopback latency/denoise diagnostic")
    p.add_argument("--model", default="gruunet2-good")
    p.add_argument("--no-denoise", action="store_true",
                   help="raw passthrough (reference rtmds behavior)")
    p.add_argument("--gain", type=float, default=2.0,
                   help="output gain (rtmds.py applies x2)")
    p.add_argument("--device", default=None, help="sounddevice device id")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="auto-stop after N seconds (0 = run until Ctrl-C)")
    p.add_argument("--torch-device", default=None,
                   help="where the fast step runs: the card unless 'cpu'")
    args = p.parse_args(argv)

    if not playback_available():
        p.error("sounddevice is not installed / no audio hardware; "
                "this diagnostic needs a real audio device")
    import sounddevice as sd

    if args.no_denoise:
        step, where = None, ""
    else:
        from audio_denoising_torch.device import resolve_device
        from audio_denoising_torch.hub import load_pretrained
        from audio_denoising_torch.runtime.engine import (
            fast_init_state, make_fast_step)
        device = resolve_device(args.torch_device)
        cfg, model = load_pretrained(args.model)
        fast = make_fast_step(cfg, model, device)
        state = fast_init_state(cfg, model, 1, device)
        hop = cfg.dsp.hop_length
        where = f", the fast step on {device}"

        def step(chunk: np.ndarray) -> np.ndarray:
            nonlocal state
            x = torch.from_numpy(np.ascontiguousarray(chunk[None])).to(device)
            state, out = fast(state, x)
            return out[0].cpu().numpy()

    # the reference runs the device at 48 kHz; the denoising branch clocks
    # it at the model's rate, or the audio is spectrally mis-mapped
    sr = 48000 if args.no_denoise else cfg.dsp.sample_rate
    hop = 768 if args.no_denoise else hop

    def callback(indata, outdata, frames, t, status):
        if status:
            print(status, flush=True)
        mono = indata[:, 0].astype(np.float32)
        out = mono if step is None else step(mono)
        outdata[:, 0] = np.clip(out * args.gain, -1.0, 1.0)

    print(f"loopback running (sr={sr}, block={hop}{where}); Ctrl-C to "
          f"stop")
    with sd.Stream(samplerate=sr, blocksize=hop, channels=1,
                   dtype="float32", callback=callback, device=args.device):
        try:
            if args.seconds > 0:
                sd.sleep(int(args.seconds * 1000))
            else:
                while True:
                    sd.sleep(1000)
        except KeyboardInterrupt:
            pass
    return 0

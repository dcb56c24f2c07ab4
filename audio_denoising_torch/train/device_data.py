"""Training data synthesized on the device (JAX counterpart
train/device_data.py).

The host sampler moves every batch's waveforms to the device. Here the
whole corpus goes to the card once (``DeviceCorpus``: the reference
corpus is 24 MB, smaller than one batch of features) and every batch is
made there:

- clean crops: random windows into the concatenated corpus (a window may
  straddle a file boundary, as the reference's collect-files-until-full
  concatenation does, utils.py:121-164);
- noise: random crops of a second corpus of real noise, or the white and
  brown synthetic mixture drawn on the device;
- gain: uniform in ``noise_gain``, or solved from the crops' energies for
  a target SNR drawn uniformly in ``snr_range_db`` (clamped to [0.02, 6]);
  with ``identity_prob`` an example gets no noise at all;
- mixture: clip(clean + gain * noise, -1, 1) (combine_audio,
  utils.py:368-372).

The random draws (``draw``) are kept apart from the synthesis
(``synthesize``): the draws come from a ``torch.Generator`` on the
corpus's device, and the synthesis is a pure function of draws and
buffers, so it can be fed the JAX sampler's draws and compared.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_denoising_torch.io.cache import AudioCache


class DeviceCorpus:
    """A concatenated mono corpus as one float32 tensor on a device."""

    def __init__(self, buffer: torch.Tensor, sample_rate: int):
        self.buffer = buffer
        self.sample_rate = sample_rate

    @classmethod
    def from_paths(cls, paths: Sequence[str], sample_rate: int = 48000,
                   max_samples: int = 200_000_000,
                   device=None) -> "DeviceCorpus":
        """Load and monotize the files (the first channel), resample once
        per source rate to ``sample_rate`` on ``device``, and keep one
        buffer there (the card unless ``"cpu"``)."""
        from audio_denoising_torch.device import resolve_device
        from audio_denoising_torch.ops.resample import resample
        from audio_denoising_torch.pipeline import fp32_convs

        device = resolve_device(device)
        cache = AudioCache()
        by_rate = {}
        total = 0
        for p in paths:
            samples, sr = cache.load(p)
            mono = samples[0] if samples.ndim == 2 else samples
            by_rate.setdefault(sr, []).append(mono.astype(np.float32))
            total += mono.shape[-1]
            if total >= max_samples:
                break
        pieces = []
        for sr, chunks in sorted(by_rate.items()):
            buf = torch.from_numpy(np.concatenate(chunks)).to(device)
            if sr != sample_rate:
                with torch.no_grad(), fp32_convs():
                    buf = resample(buf[None], sr, sample_rate)[0]
            pieces.append(buf)
        if not pieces:
            raise ValueError("no usable corpus files")
        return cls(torch.cat(pieces), sample_rate)

    def __len__(self):
        return int(self.buffer.shape[0])


class Draws(NamedTuple):
    """One batch's random draws."""
    starts: torch.Tensor                  # (B,) clean crop starts
    noise_starts: Optional[torch.Tensor]  # (B,) with a noise corpus
    white: Optional[torch.Tensor]         # (B, crop) N(0, 1) without one
    level: torch.Tensor                   # (B, 1) gain, or SNR in dB
    keep: Optional[torch.Tensor]          # (B, 1) bool: the example is
                                          # noisy (with identity_prob)


def synthesize(draws: Draws, buf: torch.Tensor,
               noise_buf: Optional[torch.Tensor], crop_samples: int,
               snr_range_db: Optional[Tuple[float, float]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mixture, clean), each (B, crop_samples) float32, from ``draws``
    (JAX device_data.py:118-164)."""
    span = torch.arange(crop_samples, device=buf.device)
    clean = buf[draws.starts[:, None] + span]
    if noise_buf is not None:
        noise = noise_buf[draws.noise_starts[:, None] + span]
    else:
        white = draws.white

        def peak_norm(v):
            return v / torch.clamp(v.abs().amax(dim=-1, keepdim=True),
                                   min=1e-6)

        noise = peak_norm(0.7 * peak_norm(white)
                          + 0.3 * peak_norm(torch.cumsum(white, dim=-1)))
    if snr_range_db is not None:
        e_c = torch.mean(clean ** 2, dim=-1, keepdim=True)
        e_n = torch.mean(noise ** 2, dim=-1, keepdim=True)
        gain = torch.sqrt(e_c / torch.clamp(e_n, min=1e-10)) \
            * 10.0 ** (-draws.level / 20.0)
        gain = torch.clamp(gain, 0.02, 6.0)
    else:
        gain = draws.level
    if draws.keep is not None:
        gain = gain * draws.keep
    mixture = torch.clamp(clean + gain * noise, -1.0, 1.0)
    return mixture.float(), clean.float()


def make_device_sampler(corpus: DeviceCorpus, crop_samples: int,
                        batch_size: int,
                        noise_gain: Tuple[float, float] = (0.2, 1.0),
                        noise_corpus: Optional[DeviceCorpus] = None,
                        snr_range_db: Optional[Tuple[float, float]] = None,
                        identity_prob: float = 0.0):
    """-> ``sample(generator) -> (mixture, clean)``, both (batch_size,
    crop_samples) on the corpus's device, drawn from ``generator`` (a
    ``torch.Generator`` on that device) and synthesized there
    (``synthesize``).

    ``snr_range_db``: each example's noise gain is solved from the crop
    energies to hit a target SNR drawn uniformly in [lo, hi] dB, clamped
    to [0.02, 6] so silent clean crops still carry audible noise and loud
    noise crops stay short of the clip. ``identity_prob``: each example
    is mixed with no noise (mixture == clean) with this probability."""
    buf = corpus.buffer
    nbuf = noise_corpus.buffer if noise_corpus is not None else None
    n = int(buf.shape[0])
    if n < crop_samples:
        raise ValueError("corpus shorter than one crop")
    if nbuf is not None and int(nbuf.shape[0]) < crop_samples:
        raise ValueError("noise corpus shorter than one crop")
    dev = buf.device
    lo, hi = (noise_gain if snr_range_db is None else snr_range_db)

    def draw(gen: torch.Generator) -> Draws:
        starts = torch.randint(0, n - crop_samples, (batch_size,),
                               generator=gen, device=dev)
        noise_starts = white = None
        if nbuf is not None:
            noise_starts = torch.randint(
                0, int(nbuf.shape[0]) - crop_samples, (batch_size,),
                generator=gen, device=dev)
        else:
            white = torch.randn((batch_size, crop_samples), generator=gen,
                                device=dev)
        level = lo + (hi - lo) * torch.rand((batch_size, 1), generator=gen,
                                            device=dev)
        keep = None
        if identity_prob > 0.0:
            keep = torch.rand((batch_size, 1), generator=gen,
                              device=dev) < 1.0 - identity_prob
        return Draws(starts, noise_starts, white, level, keep)

    def sample(gen: torch.Generator):
        return synthesize(draw(gen), buf, nbuf, crop_samples, snr_range_db)

    return sample

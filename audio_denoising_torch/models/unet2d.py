"""The 2-D conv U-Net family over (freq, time) log-magnitude spectrograms
(JAX counterpart models/unet2d.py): the reference's UNet2d (unet.py:116),
UNet2d3 (unet3.py:116), UNet2d4 (unet4.py:116, all 64 channels) and the
wide UNet2d4 (unet2.py:116), sharing one block grammar:

- a down block: Conv2d (padding 1), InstanceNorm2d where the spec says
  so, PReLU (unet4.py:233-248);
- an up block: ConvTranspose2d (padding 1, a fixed output padding),
  InstanceNorm2d, PReLU, then the skip concatenation (unet4.py:211-230);
- a GaussianSmearing field over sqrt-spaced bin positions concatenated
  to the input (unet4.py:158), a constant buffer here.

Parameter names are the reference's state-dict keys (``dcl_*.layers.*``,
``ucl_*.layers.*``, ``ucl_0.*``), so the ``.npz`` checkpoints load with
``load_state_dict``. Training adds elementwise dropout after each block's
PReLU (the reference's nn.Dropout, unet4.py:118), drawn from a generator
the trainer passes; without one the layer is the identity, so serving is
unchanged. The models are stateless: every window is independent, batch
and time run in parallel.
"""

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from audio_denoising_torch.models import base
from audio_denoising_torch.ops.convs import conv2d, conv_transpose2d


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d's default (no affine, no running statistics):
    each (sample, channel) normalized over (bins, frames) with the biased
    variance, at inference too."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


# Layer specs: downs (name, in, out, kernel, stride, norm), in None for the
# input plus the smearing channels; ups (name, in, out, kernel, stride,
# output_padding); final (name, in, kernel, stride, output_padding), all
# with padding 1. Channel letters follow the reference's init bodies.
def _spec(widths: Sequence[int]) -> Dict:
    A, B, C, D, E, F = widths
    return {
        "downs": [
            ("dcl_1", None, A, 3, 2, True),
            ("dcl_2", A, B, 3, 2, True),
            ("dcl_3", B, C, 3, 2, True),
            ("dcl_4", C, D, 3, 2, True),
            ("dcl_5", D, E, 3, 2, False),
            ("dcl_6", E, F, (4, 3), (3, 2), False),
        ],
        "ups": [
            ("ucl_1", F, E, (4, 3), (3, 2), 0),
            ("ucl_2", E + E, D, 3, 2, (1, 1)),
            ("ucl_3", D + D, C, 3, 2, (0, 1)),
            ("ucl_4", C + C, B, 3, 2, 0),
            ("ucl_5", B + B, A, 3, 2, (0, 1)),
        ],
        "final": ("ucl_0", A + A, 3, 2, 0),
    }


_UNET2D_SPEC = {  # unet.py: channels 64/64/128/128/256/256, all k3 s2
    "downs": [
        ("dcl_1", None, 64, 3, 2, True),
        ("dcl_2", 64, 64, 3, 2, True),
        ("dcl_3", 64, 128, 3, 2, True),
        ("dcl_4", 128, 128, 3, 2, True),
        ("dcl_5", 128, 256, 3, 2, False),
        ("dcl_6", 256, 256, 3, 2, False),
    ],
    "ups": [
        ("ucl_1", 256, 256, 3, 2, (1, 0)),
        ("ucl_2", 512, 128, 3, 2, (1, 1)),
        ("ucl_3", 256, 128, 3, 2, (0, 1)),
        ("ucl_4", 256, 64, 3, 2, 0),
        ("ucl_5", 128, 64, 3, 2, (0, 1)),
    ],
    "final": ("ucl_0", 128, 3, 2, 0),
}

_UNET2D3_SPEC = {  # unet3.py: 3 levels, mixed kernels
    "downs": [
        ("dcl_1", None, 64, 7, (5, 3), True),
        ("dcl_2", 64, 128, 5, 3, True),
        ("dcl_3", 128, 256, (9, 3), 3, True),
    ],
    "ups": [
        ("ucl_1", 256, 128, (9, 3), 3, (0, 1)),
        ("ucl_2", 256, 64, 5, 3, (0, 2)),
    ],
    "final": ("ucl_0", 128, 7, (5, 3), 1),
}

SPECS = {
    "UNet2d": _UNET2D_SPEC,
    "UNet2d3": _UNET2D3_SPEC,
    "UNet2d4": _spec([64, 64, 64, 64, 64, 64]),        # unet4.py
    "UNet2d4Wide": _spec([64, 64, 128, 128, 256, 256]),  # unet2.py
}


class _Block(nn.Module):
    """The reference's block: ``layers`` holds the conv, the norm's slot
    where there is one (no parameters) and the PReLU."""

    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class UNet2d(nn.Module):
    """``apply(logmag (C, bins, T)) -> residual (C, bins', T')``: the
    reference treats the channel axis as the conv batch axis
    (unet4.py:147-194). Only the frame counts ``compatible_frames``
    accepts pass the decoder's fixed output paddings."""

    def __init__(self, arch: str = "UNet2d4", chnls_in: int = 1,
                 chnls_out: int = 1, chnls_gs: int = 32, bins: int = 241):
        super().__init__()
        self.arch = arch
        self.spec = SPECS[arch]
        self.chnls_in = chnls_in
        self.chnls_out = chnls_out
        self.chnls_gs = chnls_gs
        self.bins = bins
        self._frames: Dict[Tuple[int, int], int] = {}
        self.register_buffer("smear", torch.from_numpy(
            base.gaussian_smearing(bins, chnls_gs, sqrt_positions=True)),
            persistent=False)                              # (S, bins)
        for name, cin, cout, k, s, norm in self.spec["downs"]:
            cin = chnls_in + chnls_gs if cin is None else cin
            conv = nn.Conv2d(cin, cout, k, s, padding=1)
            setattr(self, name, _Block(
                [conv, nn.Identity(), nn.PReLU()] if norm
                else [conv, nn.PReLU()]))
        for name, cin, cout, k, s, _op in self.spec["ups"]:
            setattr(self, name, _Block([
                nn.ConvTranspose2d(cin, cout, k, s, padding=1),
                nn.Identity(), nn.PReLU()]))
        name, cin, k, s, _op = self.spec["final"]
        setattr(self, name, nn.ConvTranspose2d(cin, chnls_out, k, s,
                                               padding=1))

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "UNet2d":
        """Load a reference state dict (``base.load_reference_params``:
        the smearing offsets are checked, not loaded). The reference's
        UNet2d (unet.py) also holds an MLP its forward never calls; its
        ``mlp.*`` keys are not loaded, as the JAX model reads none of
        them."""
        return base.load_reference_params(
            self, {k: v for k, v in params.items()
                   if not k.startswith("mlp.")}, self.chnls_gs)

    def apply(self, logmag: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              dropout: float = 0.0,
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """logmag (C, bins, T) -> residual (C, bins', T'). With a
        ``generator`` and ``dropout`` > 0, each block's output after its
        PReLU keeps each element with probability 1 - dropout, scaled by
        1 / (1 - dropout), the mask drawn from ``generator`` (on the
        input's device) block by block in order; otherwise the identity
        (JAX models/unet2d.py:163-180). ``rows`` = (start, global batch)
        says that ``logmag`` holds rows start.. of a larger batch: each
        mask is drawn at the global batch's shape and these rows kept, so
        a data-parallel shard drops what the whole batch would."""
        def drop(h):
            if generator is None or dropout <= 0.0:
                return h
            keep = 1.0 - dropout
            shape, start = h.shape, 0
            if rows is not None:
                start, shape = rows[0], (rows[1],) + tuple(h.shape[1:])
            mask = torch.rand(shape, generator=generator, device=h.device,
                              dtype=h.dtype)[start:start + h.shape[0]] < keep
            return torch.where(mask, h / keep, torch.zeros_like(h))

        n, _, t = logmag.shape
        smear = self.smear.to(logmag.dtype)[None, :, :, None]
        x = torch.cat([logmag[:, None],
                       smear.expand(n, -1, -1, t)], dim=1)
        encs: List[torch.Tensor] = []
        for name, _cin, _cout, _k, s, norm in self.spec["downs"]:
            layers = getattr(self, name).layers
            x = conv2d(x, layers[0].weight, layers[0].bias, stride=s,
                       padding=1)
            if norm:
                x = instance_norm_2d(x)
            x = drop(prelu(x, layers[-1].weight))
            encs.append(x)
        h = encs[-1]
        for i, (name, _cin, _cout, _k, s, op) in enumerate(self.spec["ups"]):
            layers = getattr(self, name).layers
            h = conv_transpose2d(h, layers[0].weight, layers[0].bias,
                                 stride=s, padding=1, output_padding=op)
            h = drop(prelu(instance_norm_2d(h), layers[2].weight))
            h = torch.cat([h, encs[len(encs) - 2 - i]], dim=1)
        name, _cin, _k, s, op = self.spec["final"]
        final = getattr(self, name)
        h = conv_transpose2d(h, final.weight, final.bias, stride=s,
                             padding=1, output_padding=op)
        return h[:, 0]

    def forward(self, logmag: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout: float = 0.0) -> torch.Tensor:
        return self.apply(logmag, generator, dropout)

    # -- shape compatibility ---------------------------------------------
    def _round_trip(self, bins: int, t: int) -> Optional[Tuple[int, int]]:
        """The encoder's and decoder's spatial sizes: the final (bins',
        t'), or None where a decoder level misses its skip (the concat
        would fail). The reference fixes the output paddings at
        construction (unet4.py:211-230), so only some frame counts pass."""
        sizes = [(bins, t)]
        for _n, _ci, _co, k, s, _norm in self.spec["downs"]:
            (kh, kw), (sh, sw) = _pair(k), _pair(s)
            h, w = sizes[-1]
            sizes.append(((h + 2 - kh) // sh + 1, (w + 2 - kw) // sw + 1))
        h, w = sizes[-1]
        n_down = len(self.spec["downs"])
        for i, (_n, _ci, _co, k, s, op) in enumerate(self.spec["ups"]):
            (kh, kw), (sh, sw), (oph, opw) = _pair(k), _pair(s), _pair(op)
            h = (h - 1) * sh - 2 + kh + oph
            w = (w - 1) * sw - 2 + kw + opw
            if (h, w) != sizes[n_down - 1 - i]:
                return None
        _n, _ci, k, s, op = self.spec["final"]
        (kh, kw), (sh, sw), (oph, opw) = _pair(k), _pair(s), _pair(op)
        return ((h - 1) * sh - 2 + kh + oph, (w - 1) * sw - 2 + kw + opw)

    def compatible_frames(self, t: int, max_extra: int = 512) -> int:
        """The smallest t' >= t the network takes whose output has at
        least t frames (pad the spectrogram to t', crop the output back).
        A search over up to ``max_extra`` counts, kept per ``t``: a
        stream's window has one frame count."""
        key = (t, max_extra)
        if key not in self._frames:
            for t2 in range(t, t + max_extra):
                rt = self._round_trip(self.bins, t2)
                if rt is not None and rt[0] >= self.bins and rt[1] >= t:
                    self._frames[key] = t2
                    break
            else:
                raise ValueError(f"no compatible frame count near {t} "
                                 f"for {self.arch}")
        return self._frames[key]

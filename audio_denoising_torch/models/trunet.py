"""TRU-Net and its denoiser adapter (JAX counterpart models/trunet.py):
a depthwise-separable conv encoder, a bidirectional GRU over frequency,
a GRU over the compressed axis, a transposed-conv decoder (the vendored
third-party model of the reference, trunet.py:122-158: (B, 4, 257) in,
(B, 5, 257) out).

BatchNorm runs in inference mode on the imported running statistics.
Parameter and buffer names are the reference's state-dict keys, so the
checkpoints load unchanged; a reference state dict's BatchNorm counters
(``num_batches_tracked``) are not loaded, as nothing at inference reads
them.
"""

from typing import List, Mapping

import torch
from torch import nn

from audio_denoising_torch.models.gru import GRU
from audio_denoising_torch.ops.convs import conv1d, conv_transpose1d


class BatchNorm1d(nn.Module):
    """Inference-mode nn.BatchNorm1d on (B, C, L): weight and bias, the
    running statistics as buffers."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        col = lambda v: v[None, :, None]
        return ((x - col(self.running_mean))
                * torch.rsqrt(col(self.running_var) + self.eps)
                * col(self.weight) + col(self.bias))


class _Named(nn.Module):
    """One block of the reference, its nn.Sequential under ``name`` as a
    ModuleList indexed alike (ReLUs hold the slots without parameters)."""

    def __init__(self, name: str, layers: List[nn.Module]):
        super().__init__()
        self.seq_name = name
        setattr(self, name, nn.ModuleList(layers))

    @property
    def seq(self) -> nn.ModuleList:
        return getattr(self, self.seq_name)


class _GRUBlock(nn.Module):
    """``GRU``, then a 1x1 conv, BatchNorm and ReLU (trunet.py:45-58)."""

    def __init__(self, gru: GRU, gru_out: int):
        super().__init__()
        self.GRU = gru
        self.conv = nn.ModuleList([nn.Conv1d(gru_out, 64, 1),
                                   BatchNorm1d(64)])


class TRUNet(nn.Module):
    """``apply(x (B, 4, F)) -> (B, 5, F')``, the vendored network."""

    # (name, in, out, kernel, stride, kind) per block (trunet.py:125-138)
    DOWNS = [("down1", 4, 64, 5, 2, "std"),
             ("down2", 64, 128, 3, 1, "dws"),
             ("down3", 128, 128, 5, 2, "dws"),
             ("down4", 128, 128, 3, 1, "dws"),
             ("down5", 128, 128, 5, 2, "dws"),
             ("down6", 128, 128, 3, 2, "dws")]
    UPS = [("up1", 64, 64, 3, 2, "FirstTrCNN"),
           ("up2", 192, 64, 5, 2, "TrCNN"),
           ("up3", 192, 64, 3, 1, "TrCNN"),
           ("up4", 192, 64, 5, 2, "TrCNN"),
           ("up5", 192, 64, 3, 1, "TrCNN"),
           ("up6", 128, 5, 5, 2, "LastTrCNN")]

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, kind in self.DOWNS:
            if kind == "std":
                setattr(self, name, _Named("StandardConv1d", [
                    nn.Conv1d(cin, cout, k, s, padding=s // 2)]))
            else:
                setattr(self, name, _Named("DepthwiseSeparableConv1d", [
                    nn.Conv1d(cin, cout, 1), BatchNorm1d(cout), nn.ReLU(),
                    nn.Conv1d(cout, cout, k, s, padding=k // 2,
                              groups=cout), BatchNorm1d(cout), nn.ReLU()]))
        self.FGRU = _GRUBlock(GRU(128, 64, bidirectional=True), 128)
        self.TGRU = _GRUBlock(GRU(64, 128), 128)
        for name, cin, cout, k, s, kind in self.UPS:
            layers = [nn.Conv1d(cin, cout, 1), BatchNorm1d(cout), nn.ReLU(),
                      nn.ConvTranspose1d(cout, cout, k, s, padding=s // 2)]
            if kind != "LastTrCNN":
                layers += [BatchNorm1d(cout), nn.ReLU()]
            setattr(self, name, _Named(kind, layers))

    def load_params(self, params: Mapping[str, torch.Tensor]) -> "TRUNet":
        """Load a reference state dict; its BatchNorm counters are
        dropped."""
        self.load_state_dict(
            {k: v for k, v in params.items()
             if not k.endswith(".num_batches_tracked")}, strict=True)
        return self

    # -- blocks -------------------------------------------------------------
    def _std_conv(self, name: str, x: torch.Tensor, s: int) -> torch.Tensor:
        conv = getattr(self, name).seq[0]
        return torch.relu(conv1d(x, conv.weight, conv.bias, stride=s,
                                 padding=s // 2))

    def _dws_conv(self, name: str, x: torch.Tensor, k: int,
                  s: int) -> torch.Tensor:
        seq = getattr(self, name).seq
        x = conv1d(x, seq[0].weight, seq[0].bias)
        x = torch.relu(seq[1](x))
        x = conv1d(x, seq[3].weight, seq[3].bias, stride=s, padding=k // 2,
                   groups=x.shape[1])
        return torch.relu(seq[4](x))

    def _gru_block(self, block: _GRUBlock, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, C_in) -> (B, 64, L)."""
        out, _ = block.GRU.apply(x)
        conv, bn = block.conv
        out = conv1d(out.transpose(1, 2), conv.weight, conv.bias)
        return torch.relu(bn(out))

    def _tr_seq(self, name: str, x: torch.Tensor, s: int) -> torch.Tensor:
        seq = getattr(self, name).seq
        x = conv1d(x, seq[0].weight, seq[0].bias)
        x = torch.relu(seq[1](x))
        x = conv_transpose1d(x, seq[3].weight, seq[3].bias, stride=s,
                             padding=s // 2)
        if len(seq) > 4:
            x = torch.relu(seq[4](x))
        return x

    @staticmethod
    def _pad_cat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Pad x1's length to x2's, or crop it (F.pad with negative pads
        crops), then concatenate the channels (trunet.py:95-98)."""
        diff = x2.shape[-1] - x1.shape[-1]
        left, right = diff // 2, diff - diff // 2
        x1 = torch.nn.functional.pad(x1, (left, right))
        return torch.cat([x1, x2], dim=1)

    # -- forward --------------------------------------------------------------
    def forward_frames(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self._std_conv("down1", x, 2)
        x2 = self._dws_conv("down2", x1, 3, 1)
        x3 = self._dws_conv("down3", x2, 5, 2)
        x4 = self._dws_conv("down4", x3, 3, 1)
        x5 = self._dws_conv("down5", x4, 5, 2)
        x6 = self._dws_conv("down6", x5, 3, 2)
        x8 = self._gru_block(self.FGRU, x6.transpose(1, 2))
        x10 = self._gru_block(self.TGRU, x8.transpose(1, 2))
        x11 = self._tr_seq("up1", x10, 2)
        x12 = self._tr_seq("up2", self._pad_cat(x11, x5), 2)
        x13 = self._tr_seq("up3", self._pad_cat(x12, x4), 1)
        x14 = self._tr_seq("up4", self._pad_cat(x13, x3), 2)
        x15 = self._tr_seq("up5", self._pad_cat(x14, x2), 1)
        return self._tr_seq("up6", self._pad_cat(x15, x1), 2)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_frames(x)

    def forward(self, x):
        return self.apply(x)


class TRUNetDenoiser(TRUNet):
    """TRUNet on the framework's residual-denoising contract (JAX
    models/trunet.py:163-218; the featurization is the JAX package's own,
    as the reference never connects TRUNet to audio): each spectrogram
    frame becomes 4 channels over its F bins (log1p magnitude, the delta
    to the previous frame, the delta along frequency, a bin-position
    ramp), and output channel 0 is the residual log-magnitude. It has the
    stateless U-Net surface (``compatible_frames``; image in, image out),
    so it serves through ``offline_denoise_stateless`` and engine mode
    ``unet``. Its parameters are TRUNet's, under the same names."""

    def __init__(self, num_bins: int = 257):
        super().__init__()
        self.num_bins = num_bins
        self.register_buffer("pos", torch.linspace(0.0, 1.0, num_bins),
                             persistent=False)

    def compatible_frames(self, t: int) -> int:
        return t                         # a per-frame model: any count

    def apply(self, img: torch.Tensor) -> torch.Tensor:
        """img: (B, F, T) log1p magnitude -> (B, F, T) residual. The
        batch of the network is B * T frames."""
        b, f, t = img.shape
        frames = img.transpose(1, 2).reshape(b * t, f)
        dt = img - torch.nn.functional.pad(img[..., :-1], (1, 0))
        dt = dt.transpose(1, 2).reshape(b * t, f)
        df = frames - torch.nn.functional.pad(frames[:, :-1], (1, 0))
        pos = self.pos.to(img.dtype).expand(b * t, f)
        x = torch.stack([frames, dt, df, pos], dim=1)      # (B*T, 4, F)
        resid = self.forward_frames(x)[:, 0, :f]            # (B*T, F)
        return resid.reshape(b, t, f).transpose(1, 2)

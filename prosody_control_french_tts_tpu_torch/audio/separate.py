"""Spectral-mask vocal isolation (MaskNet), inference, in PyTorch.

Port of the inference half of the JAX package's ``audio/separate.py``, the
learned stand-in for the reference's Demucs step (``denoise: mask``): a
small dilated conv network over log-magnitude STFT frames predicts a soft
vocal mask, which is applied to the complex spectrum and inverted by
overlap-add. The packaged checkpoint (``pretrained/masknet.npz``: dim 256,
4 layers, 513 bins, stored as float16; a copy of the JAX package's) loads
through ``convert.masknet_params_from_jax``.

Numerics follow the flax module: the convolutions run in bfloat16 (inputs
and weights cast, output bfloat16, the bias added in bfloat16), as do the
tanh-approximated gelu (one rounding per operation, as XLA evaluates it) and
the residual sums; the LayerNorms (epsilon 1e-6,
variance as E[x²] − E[x]²) and the output Dense run in float32. The
convolutions and the Dense are library calls (cuDNN, cuBLAS with TF32 off):
in the JAX package they are XLA ops, not Pallas kernels.

Training (``synth_music``, the mixtures, ``pretrain_masknet``) is not
ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import masknet_params_from_jax
from ..ops.kernels import dsp_precision, resolve_device
from ..ops.stft import istft_overlap_add, stft
from ..utils.wavio import Audio, resample

N_FFT = 1024
HOP = 256
PACKAGED_WEIGHTS = Path(__file__).parent / "pretrained" / "masknet.npz"
LN_EPS = 1e-6  # flax LayerNorm's default


def load_params(path: str | Path) -> dict:
    """``.npz`` of '/'-joined flax paths → nested dict of numpy arrays;
    floating leaves upcast to float32 (checkpoints may be stored float16)."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        v = data[key]
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        node[parts[-1]] = v
    return tree


class _Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax ``LayerNorm(dtype=float32)``: statistics of x in float32,
        (x − mean) · (rsqrt(var + eps) · scale) + bias."""
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (xf - mu) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


class _Conv(nn.Module):
    """flax ``Conv(dim, 5, padding="SAME", kernel_dilation=d,
    dtype=bfloat16)`` over frames [T, C] → [T, dim] bfloat16."""

    def __init__(self, c_in: int, c_out: int, dilation: int, k: int = 5):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.dilation = dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv1d(x.to(torch.bfloat16).T[None], self.weight.to(torch.bfloat16),
                     padding=(k - 1) // 2 * self.dilation, dilation=self.dilation)
        return y[0].T + self.bias.to(torch.bfloat16)


class MaskNet(nn.Module):
    """log|X| frames [T, F] → vocal mask (0..1) [T, F]: level normalisation
    over the active frames, a dilated conv stack over time (frequency as
    features), dilations 1, 3, 9, 27."""

    def __init__(self, dim: int = 256, layers: int = 4, dilations=(1, 3, 9, 27)):
        super().__init__()
        bins = N_FFT // 2 + 1
        self.conv_in = _Conv(bins, dim, dilations[0])
        self.norms = nn.ModuleList(_Norm(dim) for _ in range(layers - 1))
        self.convs = nn.ModuleList(_Conv(dim, dim, dilations[(i + 1) % len(dilations)]) for i in range(layers - 1))
        self.norm_out = _Norm(dim)
        self.dense = nn.Linear(dim, bins)

    def forward(self, logmag: torch.Tensor) -> torch.Tensor:
        # level normalisation over frames within 2.5 log10 units (50 dB) of
        # the loudest frame
        fm = logmag.mean(-1, keepdim=True)  # [T, 1]
        w = (fm > fm.amax(-2, keepdim=True) - 2.5).to(logmag.dtype)
        mu = (logmag * w).sum((-2, -1), keepdim=True) / torch.clamp(
            w.sum((-2, -1), keepdim=True) * logmag.shape[-1], min=1.0
        )
        x = gelu_tanh_bf16(self.conv_in(logmag - mu))
        for norm, conv in zip(self.norms, self.convs):
            x = x + gelu_tanh_bf16(conv(norm(x)))
        x = self.norm_out(x)
        return torch.sigmoid(torch.matmul(x, self.dense.weight.T) + self.dense.bias)


def gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """The flax model's gelu (tanh approximation, the default) on a bfloat16
    tensor, one rounding to bfloat16 per operation as XLA evaluates it:
    ``x * 0.5 * (1 + tanh(c2 * (x + c1 * x³)))`` with x³ = (x · x) · x and
    c1, c2 rounded to bfloat16. ``F.gelu`` rounds once at the end and
    differs in the last bit of about 40 % of the elements."""
    c1 = torch.tensor(0.044715, dtype=torch.bfloat16, device=x.device)
    c2 = torch.tensor(float(np.float32(np.sqrt(2.0 / np.pi))), dtype=torch.bfloat16, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x))))
    return x * cdf


def _logmag(spec: torch.Tensor) -> torch.Tensor:
    return torch.log10(spec.abs() + 1e-6)


def separate_core(model: MaskNet, x: torch.Tensor, length: int) -> torch.Tensor:
    """One chunk: STFT, mask, masked inverse STFT."""
    spec = stft(x, n_fft=N_FFT, hop_length=HOP, center=True)  # [F, T']
    mask = model(_logmag(spec).T)  # [T', F]
    return istft_overlap_add(spec * mask.T, N_FFT, HOP, length)


class MaskSeparator:
    """Separator: ``separate(audio) -> Audio`` (the vocals), on ``device``.
    The weights go to the device once, when the separator is built."""

    SAMPLE_RATE = 16000  # the packaged checkpoint's training rate
    CHUNK = 1 << 19  # samples per pass (~33 s)
    HALO = 96 * HOP  # context each side of a chunk: covers the dilated stack's ±80-frame receptive field

    def __init__(
        self,
        params=None,
        weights_path: str | Path | None = None,
        dim: int = 256,
        layers: int = 4,
        autoload: bool = True,
        device="cuda",
    ):
        """``params``: a flax MaskNet tree of numpy arrays (as
        ``load_params`` returns); ``weights_path``: an ``.npz`` checkpoint;
        neither: the packaged checkpoint when the shape is the packaged one."""
        self.device = resolve_device(device)
        self.model = MaskNet(dim=dim, layers=layers)
        if weights_path is not None:
            params = load_params(weights_path)
        elif params is None and autoload and dim == 256 and layers == 4 and PACKAGED_WEIGHTS.exists():
            params = load_params(PACKAGED_WEIGHTS)
        self.loaded = params is not None
        if self.loaded:
            self.model.load_state_dict(masknet_params_from_jax(params))
        self.model.to(self.device).eval()

    def separate(self, audio: Audio) -> Audio:
        """Vocal estimate at the input's own rate. The mask is a function of
        the checkpoint's 16 kHz STFT bins, so the signal is resampled to
        16 kHz and back, and processed in fixed chunks with halos."""
        if not self.loaded:
            raise ValueError("MaskSeparator has no weights; pass params or weights_path")
        dsp_precision()
        a = audio.to_mono()
        orig_rate = a.rate
        if a.rate != self.SAMPLE_RATE:
            a = resample(a, self.SAMPLE_RATE)
        x = torch.from_numpy(np.ascontiguousarray(a.samples, np.float32)).to(self.device)
        n = x.shape[-1]
        C, H = self.CHUNK, self.HALO
        out = torch.zeros(n, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            for s in range(0, n, C):
                lo, hi = max(s - H, 0), min(s + C + H, n)
                seg = torch.zeros(C + 2 * H, dtype=torch.float32, device=self.device)
                seg[: hi - lo] = x[lo:hi]
                y = separate_core(self.model, seg, C + 2 * H)
                out[s : min(s + C, n)] = y[s - lo : s - lo + min(C, n - s)]
        res = Audio(out.cpu().numpy(), self.SAMPLE_RATE)
        if orig_rate != self.SAMPLE_RATE:
            res = resample(res, orig_rate)
        return res

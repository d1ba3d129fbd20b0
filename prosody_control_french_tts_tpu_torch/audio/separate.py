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

The training half (``pretrain_masknet``, the recipe behind the packaged
checkpoint) trains on (mixture, vocals) pairs made on the host with numpy,
bit for bit as the JAX package makes them: compositional synthetic speech
(``align.synth_speech``), optionally REAL narration windows from the
corpus that ``PCFT_REAL_CORPUS`` names, over beds of four kinds
(``synth_bed``). The loss is the power-compressed spectral MSE of the JAX
step, the optimiser ``optax.adam(cosine_decay_schedule(lr, steps,
alpha=0.05))`` (``models.schedules``). ``MaskNet`` takes one utterance [T,
F] or a batch [B, T, F] (the level normalisation is per item). Without the
real corpus the recipe warns, trains on synthetic vocals only and skips the
real-mixture gate, as the JAX recipe does. The packaged checkpoint stays
where it is unless ``out_path`` names it.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import masknet_params_from_jax, masknet_params_to_jax
from ..ops.kernels import dsp_precision, resolve_device
from ..ops.stft import istft_overlap_add, stft
from ..utils.wavio import Audio, resample

log = logging.getLogger(__name__)

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
    dtype=bfloat16)`` over frames [..., T, C] → [..., T, dim] bfloat16."""

    def __init__(self, c_in: int, c_out: int, dilation: int, k: int = 5):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.dilation = dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, (T, C) = self.weight.shape[-1], x.shape[-2:]
        y = F.conv1d(x.to(torch.bfloat16).reshape(-1, T, C).transpose(1, 2), self.weight.to(torch.bfloat16),
                     padding=(k - 1) // 2 * self.dilation, dilation=self.dilation)
        return (y.transpose(1, 2) + self.bias.to(torch.bfloat16)).reshape(*x.shape[:-1], -1)


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


def init_masknet(model: MaskNet, seed: int) -> None:
    """flax's default initialisation of ``MaskNet``, drawn in module order on
    the CPU from a generator seeded with ``seed``: lecun-normal kernels
    (fan-in 5·in for the convolutions), zero biases, unit LayerNorm
    scales."""
    from ..models.layers import lecun_normal

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _Conv):
                c_out, c_in, k = m.weight.shape
                m.weight.copy_(lecun_normal(k * c_in, (k, c_in, c_out), g).permute(2, 1, 0))
                m.bias.zero_()
            elif isinstance(m, _Norm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(lecun_normal(m.in_features, (m.in_features, m.out_features), g).T)
                m.bias.zero_()


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
        self.params = params
        if self.loaded:
            self.model.load_state_dict(masknet_params_from_jax(params))
        self.model.to(self.device).eval()

    def init_params(self, seed: int = 0) -> dict:
        """flax's default initialisation (``init_masknet``) on the
        separator's device; returns (and keeps as ``params``) the flax tree
        of numpy arrays. The parameters are float32 with gradients."""
        from ..align.ctc_aligner import nest

        self.model.cpu()
        init_masknet(self.model, seed)
        self.model.to(self.device)
        self.loaded = True
        self.params = nest(masknet_params_to_jax(self.model.state_dict()))
        return self.params

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


# ---------------------------------------------------------------------------
# the deterministic music-bed generator (training mixtures; host numpy, as
# the JAX package's)
# ---------------------------------------------------------------------------

_CHORDS = [  # root frequencies (Hz) of simple triads
    (130.8, 164.8, 196.0),
    (146.8, 185.0, 220.0),
    (98.0, 123.5, 146.8),
    (110.0, 138.6, 164.8),
]


def synth_music(duration_s: float, rate: int = 16000, seed: int = 0) -> np.ndarray:
    """Deterministic music bed: slow chord pads + bass line + percussive
    noise bursts — wide-band interference overlapping the speech band."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * rate)
    t = np.arange(n) / rate
    out = np.zeros(n, np.float32)
    bar = max(int(0.8 * rate), 1)
    for b in range(0, n, bar):
        chord = _CHORDS[(b // bar) % len(_CHORDS)]
        seg = slice(b, min(b + bar, n))
        tt = t[seg] - t[seg.start]
        env = np.minimum(1.0, tt / 0.02) * np.exp(-tt * 1.2)
        for f in chord:
            for harm, amp in ((1, 0.5), (2, 0.25), (3, 0.12)):
                out[seg] += amp * env * np.sin(2 * np.pi * f * harm * (t[seg] + rng.uniform(0, 1e-3)))
        out[seg] += 0.6 * env * np.sin(2 * np.pi * chord[0] / 2 * t[seg])  # bass an octave down
        for off in (0, bar // 2):  # hat/snare-ish noise bursts on the half-bar
            s0 = b + off
            if s0 + rate // 50 < n:
                burst = rng.standard_normal(rate // 50) * np.exp(-np.arange(rate // 50) / (rate / 400))
                out[s0 : s0 + rate // 50] += 0.35 * burst
    peak = np.max(np.abs(out)) + 1e-9
    return (0.5 * out / peak).astype(np.float32)


def _pink_noise(n: int, rng: np.random.Generator) -> np.ndarray:
    """1/f-shaped broadband noise via rfft shaping (float32 throughout)."""
    w = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(w)
    f = np.arange(spec.size, dtype=np.float32)
    spec = (spec / np.sqrt(np.maximum(f, 1.0))).astype(np.complex64)
    out = np.fft.irfft(spec, n).astype(np.float32)
    return (out / (np.std(out) + 1e-9)).astype(np.float32)


def _comb_reverb(x: np.ndarray, rate: int, rng: np.random.Generator) -> np.ndarray:
    """Cheap Schroeder-style reverb: a few feedback combs, enough to smear
    transients the way real rooms do."""
    out = np.array(x, np.float32)
    for delay_ms, gain in ((31.0, 0.45), (43.0, 0.35), (59.0, 0.25)):
        d = int((delay_ms + rng.uniform(-3, 3)) * rate / 1000.0)
        y = np.array(out)  # IIR comb y[n] = x[n] + g·y[n−d], d samples a block
        for k in range(1, len(y) // d + 1):
            seg = slice(k * d, min((k + 1) * d, len(y)))
            prev = slice((k - 1) * d, (k - 1) * d + (seg.stop - seg.start))
            y[seg] += gain * y[prev]
        out = y
    return (out / (np.max(np.abs(out)) + 1e-9) * (np.max(np.abs(x)) + 1e-9)).astype(np.float32)


BED_KINDS = ("chords", "noise", "reverb_chords", "babble")


def synth_bed(duration_s: float, rate: int = 16000, seed: int = 0, kind: str = "chords") -> np.ndarray:
    """Interference bed of the given kind: ``chords`` (``synth_music``),
    ``noise`` (1/f broadband), ``reverb_chords`` (the tonal bed through
    comb reverb), ``babble`` (three overlapped synthetic sentences)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * rate)
    if kind == "chords":
        return synth_music(duration_s, rate, seed)
    if kind == "noise":
        return (0.5 * _pink_noise(n, rng)).astype(np.float32)
    if kind == "reverb_chords":
        return _comb_reverb(synth_music(duration_s, rate, seed), rate, rng)
    if kind == "babble":
        from ..align.synth_speech import SynthSpec, sample_sentences, synth_sentence

        spec = SynthSpec(sample_rate=rate)
        out = np.zeros(n, np.float32)
        for v in range(3):
            sent = sample_sentences(1, seed=seed + 31 * v + 7)[0]
            s, _ = synth_sentence(sent, spec, seed=seed + 97 * v)
            off = int(rng.uniform(0, max(n - s.size, 1)))
            seg = s[: max(n - off, 0)]
            out[off : off + seg.size] += 0.5 * seg
        peak = np.max(np.abs(out)) + 1e-9
        return (0.5 * out / peak).astype(np.float32)
    raise ValueError(f"unknown bed kind {kind!r}")


# ---------------------------------------------------------------------------
# pretraining on synthetic + real-speech mixtures
# ---------------------------------------------------------------------------

# Real narration for the training recipe only (never read by the separator):
# a directory of segment_ph<N>.wav files named by PCFT_REAL_CORPUS. Unset,
# the recipe trains on synthetic vocals only.
REAL_CORPUS = Path(os.environ["PCFT_REAL_CORPUS"]) if os.environ.get("PCFT_REAL_CORPUS") else None


def real_speech_windows(
    rate: int = 16000, window_s: float = 4.0, segments: tuple[int, ...] = (2, 3, 4, 5, 6, 7, 8, 9)
) -> list[np.ndarray]:
    """Clean real French narration windows (4 s, near-silent ones skipped)
    from ``REAL_CORPUS``; segments 10 and 11 are kept for held-out
    evaluation. [] (with a warning) without the corpus."""
    from ..utils.wavio import read_wav

    if REAL_CORPUS is None or not REAL_CORPUS.is_dir():
        log.warning(
            "real-narration corpus %s missing — the 'realistic' recipe falls "
            "back to synthetic-only vocals (set PCFT_REAL_CORPUS)",
            REAL_CORPUS,
        )
        return []
    out = []
    for nseg in segments:
        p = REAL_CORPUS / f"segment_ph{nseg}.wav"
        if not p.exists():
            continue
        a = read_wav(p).to_mono()
        if a.rate != rate:
            a = resample(a, rate)
        x = np.asarray(a.samples, np.float32)
        w = int(window_s * rate)
        for s in range(0, x.size - w + 1, w):
            win = x[s : s + w]
            if np.std(win) > 1e-3:
                out.append(win)
    return out


def _mix_at_snr(speech: np.ndarray, bed: np.ndarray, snr_db: float) -> np.ndarray:
    g = 10.0 ** (-snr_db / 20.0) * (np.std(speech) + 1e-9) / (np.std(bed) + 1e-9)
    return (speech + g * bed[: speech.size]).astype(np.float32)


def _make_pairs(n: int, seed: int, rate: int = 16000, realistic: bool = True,
                real_segments: tuple[int, ...] | None = None):
    """(mixture, clean vocals) pairs. ``realistic`` (the packaged recipe)
    draws bed kinds from BED_KINDS and SNRs from −5..15 dB, and replaces
    every other synthetic vocal with a real narration window when the corpus
    is there; else chords at 0..12 dB. ``real_segments`` picks the corpus
    segments (10, 11 for held-out pairs)."""
    from ..align.synth_speech import SynthSpec, sample_sentences, synth_sentence

    spec = SynthSpec(sample_rate=rate)
    rng = np.random.default_rng(seed)
    if realistic:
        real = real_speech_windows(rate, segments=real_segments) if real_segments is not None else real_speech_windows(rate)
    else:
        real = []
    pairs = []
    for i, sent in enumerate(sample_sentences(n, seed=seed, min_words=4, max_words=8)):
        if realistic and real and i % 2 == 1:
            speech = real[int(rng.integers(0, len(real)))]
        else:
            speech, _ = synth_sentence(sent, spec, seed=seed + i)
        # +0.1 s margin: int(duration * rate) can round one sample short
        kind = BED_KINDS[int(rng.integers(0, len(BED_KINDS)))] if realistic else "chords"
        bed = synth_bed(speech.size / rate + 0.1, rate, seed=seed + 10_000 + i, kind=kind)
        snr_db = rng.uniform(-5.0, 15.0) if realistic else rng.uniform(0.0, 12.0)
        pairs.append((_mix_at_snr(speech, bed, snr_db), speech))
    return pairs


def si_snr_db(est: np.ndarray, ref: np.ndarray) -> float:
    ref = ref - ref.mean()
    est = est - est.mean()
    s = np.dot(est, ref) / (np.dot(ref, ref) + 1e-9) * ref
    e = est - s
    return float(10.0 * np.log10((np.dot(s, s) + 1e-9) / (np.dot(e, e) + 1e-9)))


def real_mixture_eval(sep: "MaskSeparator", seed: int = 0, rate: int = 16000, snrs=(0.0, 5.0, 10.0)) -> float:
    """Mean SI-SNR improvement on mixtures of held-out real narration
    (segments 10/11) with held-out beds of every kind; NaN (with a warning)
    without the corpus."""
    clips = real_speech_windows(rate, segments=(10, 11))
    if not clips:
        log.warning("no held-out real narration available — real-mixture gate SKIPPED")
        return float("nan")
    gains = []
    for i, clip in enumerate(clips[:8]):
        kind = BED_KINDS[i % len(BED_KINDS)]
        bed = synth_bed(clip.size / rate + 0.1, rate, seed=seed + 777 + i, kind=kind)
        mix = _mix_at_snr(clip, bed, float(snrs[i % len(snrs)]))
        est = np.asarray(sep.separate(Audio(mix, rate)).samples, np.float32)
        m = min(est.size, clip.size)
        g = si_snr_db(est[:m], clip[:m]) - si_snr_db(mix[:m], clip[:m])
        log.info("real-mixture eval: clip %d kind=%s snr=%+.0f dB -> gain %+.2f dB", i, kind, float(snrs[i % len(snrs)]), g)
        gains.append(g)
    return float(np.mean(gains))


def _prep_batches(pairs, batch: int, device="cpu"):
    """Magnitude spectra of the pairs: the waveforms zero-padded to one
    length (a multiple of HOP·64), through the STFT on ``device`` in chunks
    of 16 → (mix [n, T', F], clean [n, T', F], valid [n, T'] bool) numpy,
    n a multiple of ``batch``."""
    n = (len(pairs) // batch) * batch
    if n < len(pairs):
        log.info("dropping %d mixtures to fill %d-sized batches", len(pairs) - n, batch)
    Tmax = max(m.size for m, _ in pairs[:n])
    Tmax = int(np.ceil(Tmax / (HOP * 64)) * (HOP * 64))
    wav = np.zeros((2 * n, Tmax), np.float32)
    for i, (m, c) in enumerate(pairs[:n]):
        wav[2 * i, : m.size] = m
        wav[2 * i + 1, : c.size] = c
    mags = []
    CH = 16
    with torch.no_grad():
        for s in range(0, wav.shape[0], CH):
            chunk = torch.from_numpy(wav[s : s + CH]).to(device)
            mags.append(stft(chunk, N_FFT, HOP).abs().cpu().numpy())
    mag = np.concatenate(mags)[: 2 * n].transpose(0, 2, 1)  # [2n, T', F]
    Tm = mag.shape[1]
    mix = np.ascontiguousarray(mag[0::2])
    clean = np.ascontiguousarray(mag[1::2])
    valid = np.zeros((n, Tm), bool)
    for i, (m, _) in enumerate(pairs[:n]):
        valid[i, : min(1 + m.size // HOP, Tm)] = True
    return mix, clean, valid


def masknet_loss(mask: torch.Tensor, m: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Power-compressed spectral MSE: ((mask·m + 1e-4)^0.3 − (c + 1e-4)^0.3)²
    over the valid frames, divided by valid frames × bins. mask, m, c [B,
    T', F] float32; v [B, T'] bool."""
    err = (torch.pow(mask * m + 1e-4, 0.3) - torch.pow(c + 1e-4, 0.3)) * v[..., None]
    return (err * err).sum() / (v.sum() * m.shape[-1]).clamp(min=1)


def _make_step(model: MaskNet, lr: float, steps_total: int):
    """Adam on ``cosine_decay_schedule(lr, steps_total, alpha=0.05)`` of the
    compressed MSE. step(m, c, v) → loss (0-d tensor on the device)."""
    from ..models.schedules import ScheduledAdam, cosine_decay_schedule

    opt = ScheduledAdam(model.parameters(), cosine_decay_schedule(lr, steps_total, alpha=0.05))

    def step(m: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        loss = masknet_loss(model(torch.log10(m + 1e-6)), m, c, v)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def pretrain_masknet(
    out_path: str | Path = PACKAGED_WEIGHTS,
    n_mixtures: int = 256,
    epochs: int = 10,
    batch: int = 4,
    lr: float = 3e-4,
    seed: int = 0,
    target_si_snr_gain_db: float = 5.0,
    realistic: bool = True,
    target_real_gain_db: float = 3.0,
    device="cuda",
) -> tuple["MaskSeparator", float]:
    """Train on speech + bed mixtures, gate on the held-out synthetic SI-SNR
    improvement through ``separate`` (and on held-out real-speech mixtures
    when the corpus is there), save float16 weights in the JAX layout."""
    from ..align.ctc_aligner import half_tree, nest

    sep = MaskSeparator(autoload=False, device=device)
    sep.init_params(seed)
    pairs = _make_pairs(n_mixtures, seed, realistic=realistic)
    mix, clean, valid = _prep_batches(pairs, batch, sep.device)
    log.info("masknet: %d mixtures, frames %s", mix.shape[0], mix.shape[1:])
    steps_total = max(1, (mix.shape[0] // batch) * epochs)
    model = sep.model.train()
    step = _make_step(model, lr, steps_total)
    dev = sep.device
    mix_d, clean_d, valid_d = (torch.from_numpy(a).to(dev) for a in (mix, clean, valid))

    rng = np.random.default_rng(seed)
    t0 = time.time()
    sep.losses = []
    for epoch in range(epochs):
        order = rng.permutation(mix.shape[0])
        ep = []
        for s in range(0, len(order), batch):
            idx = torch.from_numpy(order[s : s + batch]).to(dev)
            ep.append(step(mix_d[idx], clean_d[idx], valid_d[idx]))
        sep.losses.append(float(torch.stack(ep).mean()))
        log.info("epoch %d: loss %.5f (%.0fs)", epoch, sep.losses[-1], time.time() - t0)
    del mix_d, clean_d, valid_d
    model.eval()
    sep.params = nest(masknet_params_to_jax(model.state_dict()))

    # held-out SI-SNR improvement through the full separate() path
    gains = []
    for mix_x, clean_x in _make_pairs(12, seed + 555, realistic=realistic, real_segments=(10, 11)):
        est = np.asarray(sep.separate(Audio(mix_x, 16000)).samples, np.float32)
        n = min(est.size, clean_x.size)
        gains.append(si_snr_db(est[:n], clean_x[:n]) - si_snr_db(mix_x[:n], clean_x[:n]))
    gain = float(np.mean(gains))
    log.info("held-out SI-SNR improvement: %.2f dB", gain)
    sep.real_gain = float("nan")
    if gain < target_si_snr_gain_db:
        raise RuntimeError(f"SI-SNR gain {gain:.2f} dB < {target_si_snr_gain_db} dB gate")
    if realistic:
        sep.real_gain = real_mixture_eval(sep, seed=seed)
        log.info("held-out REAL-speech mixture SI-SNR improvement: %.2f dB", sep.real_gain)
        if not np.isfinite(sep.real_gain):
            log.warning("real-mixture SI-SNR gate DID NOT RUN (no segment_ph10/11 under %s) — the checkpoint is "
                        "gated on synthetic mixtures only", REAL_CORPUS)
        elif sep.real_gain < target_real_gain_db:
            raise RuntimeError(f"real-mixture SI-SNR gain {sep.real_gain:.2f} dB < {target_real_gain_db} dB gate")

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    save_params(half_tree(sep.params), out_path)
    log.info("saved %s (%.1f KiB)", out_path, out_path.stat().st_size / 1024)
    return sep, gain


def save_params(params, path: str | Path) -> None:
    """The JAX layout: '/'-joined flax keys in an ``.npz``."""
    from ..align.ctc_aligner import save_params as _save

    _save(params, path)

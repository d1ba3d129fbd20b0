"""CTC forced aligner (inference): an acoustic model + Viterbi alignment.

Port of the inference half of the JAX package's ``align/ctc_aligner.py``
(the counterpart of the reference's MFA/NeMo/ctc-forced-aligner
subprocesses, Code/Aligners/Use_MFA.py, NeMo.py, CTCFA.py). A small
conv-transformer encoder (``CTCEncoder``) maps log-mel frames to character
logits; word spans come from the blank-interleaved Viterbi path
(``align.ctc``: the CUDA kernel ``csrc/ctc_viterbi.cu`` on the card).

The encoder rounds where the flax module rounds (``models.layers``): the
convolutions, the attention and the feed-forward layers in bfloat16 (the
attention's softmax too, as flax's ``MultiHeadDotProductAttention`` with
``dtype=bfloat16`` computes it), the LayerNorms and the output layer in
float32. The packaged checkpoint (``pretrained/ctc_fr_synth.npz``, a copy of
the JAX package's, pretrained on compositional synthetic French speech)
loads through ``convert.ctc_params_from_jax``.

Training: ``CTCAligner.init_params`` draws flax's default initialisation
from a ``torch.Generator`` into float32 master weights
(``models.layers.master_weights``), ``make_train_step`` is the JAX step
(Adam on ``ctc_loss(log_softmax(model(mel)))``, one unbatched utterance, no
attention mask; ``ctc_loss`` is the CUDA kernel pair ``csrc/ctc_loss.cu`` on
the card), and ``save_params`` writes the JAX layout ('/'-joined flax keys
in an ``.npz``, read back by either package's ``load_params``). The encoder
takes one sequence [T, M] or a batch [B, T, M], as the flax module
broadcasts over leading dimensions.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import ctc_params_from_jax, ctc_params_to_jax
from ..models.layers import Dense, LayerNorm, embed_normal, gelu_tanh_bf16, lecun_normal, master_weights
from ..ops.ctc_loss import ctc_loss
from ..ops.kernels import dsp_precision, resolve_device
from ..ops.stft import log_mel
from ..utils.textgridio import TextGrid
from ..utils.wavio import Audio, resample
from .base import AlignedWord, words_to_textgrid
from .ctc import ctc_forced_align, states_to_words

FR_CHARS = " abcdefghijklmnopqrstuvwxyzàâäéèêëîïôöùûüÿçœ'-"
PACKAGED_WEIGHTS = Path(__file__).parent / "pretrained" / "ctc_fr_synth.npz"
BF16 = torch.bfloat16


@dataclass
class CharVocab:
    chars: str = FR_CHARS

    @property
    def blank(self) -> int:
        return 0

    def __len__(self) -> int:
        return len(self.chars) + 1  # + blank

    def encode(self, text: str) -> list[int]:
        text = text.lower()
        return [self.chars.index(c) + 1 for c in text if c in self.chars]

    def word_spans(self, words: list[str]) -> tuple[list[int], list[tuple[int, int]]]:
        """Concatenated label sequence (spaces between words) + per-word
        [start, end) label index spans."""
        labels: list[int] = []
        spans: list[tuple[int, int]] = []
        for i, w in enumerate(words):
            if i > 0:
                labels.extend(self.encode(" "))
            start = len(labels)
            labels.extend(self.encode(w))
            spans.append((start, len(labels)))
        return labels, spans


def _flat_keys(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat_keys(v, key) if isinstance(v, dict) else {key: v})
    return out


def save_params(params: dict, path: str | Path) -> None:
    """A flax tree of arrays (nested, or flat with '/'-joined keys) →
    ``.npz`` of '/'-joined keys in sorted order, as the JAX package's
    ``save_params`` writes it (leaves keep their dtype)."""
    flat = _flat_keys(params)
    np.savez(path, **{k: np.asarray(flat[k]) for k in sorted(flat)})


def nest(flat: dict) -> dict:
    """'/'-joined keys → the nested tree (``load_params``' layout)."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def half_tree(params: dict) -> dict:
    """Floating leaves cast to float16: the packaged checkpoints' storage."""
    return {k: (np.asarray(v, np.float16) if np.issubdtype(np.asarray(v).dtype, np.floating) else np.asarray(v))
            for k, v in _flat_keys(params).items()}


def load_params(path: str | Path) -> dict:
    """``.npz`` of '/'-joined flax paths → nested dict of numpy arrays;
    floating leaves upcast to float32 (checkpoints may be stored float16)."""
    data = np.load(path)
    return nest({k: (data[k].astype(np.float32) if np.issubdtype(data[k].dtype, np.floating) else data[k])
                 for k in data.files})


class Conv(nn.Module):
    """flax ``Conv(dim, (k,), strides=(stride,), padding="SAME",
    dtype=bfloat16)`` over frames [..., T, C] → [..., ceil(T / stride), dim]
    bfloat16 (SAME puts the odd pad frame at the end)."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, dtype=BF16), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=BF16), requires_grad=False)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, (T, C) = self.weight.shape[-1], self.stride, x.shape[-2:]
        total = max((-(-T // s) - 1) * s + k - T, 0)
        xt = F.pad(x.to(BF16).reshape(-1, T, C).transpose(1, 2), (total // 2, total - total // 2))
        y = F.conv1d(xt, self.weight.to(BF16), stride=s).transpose(1, 2) + self.bias.to(BF16)
        return y.reshape(*x.shape[:-2], *y.shape[-2:])


class _SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(dtype=bfloat16)``: q, k, v and the
    output projection in bfloat16, q scaled by 1/sqrt(head dim) before the
    product, the masked softmax in bfloat16 (its sum accumulated in
    float32)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        *lead, T, dim = x.shape
        hd = dim // self.heads

        def split(t):  # [..., T, dim] -> [..., heads, T, hd]
            return t.reshape(*lead, T, self.heads, hd).transpose(-3, -2)

        q = split(self.query(x)) / torch.tensor(float(np.float32(np.sqrt(hd))), dtype=BF16, device=x.device)
        k, v = split(self.key(x)), split(self.value(x))
        att = torch.matmul(q, k.transpose(-1, -2))  # [..., heads, T, T] bfloat16
        if key_mask is not None:
            att = torch.where(key_mask, att, torch.finfo(BF16).min)  # key_mask [T] masks the keys
        u = torch.exp(att - att.amax(-1, keepdim=True))
        w = u / u.float().sum(-1, keepdim=True).to(BF16)
        o = torch.matmul(w, v).transpose(-3, -2).reshape(*lead, T, dim)
        return self.out(o)


class _Layer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = _SelfAttention(dim, heads)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Dense(dim, dim * 4)
        self.fc2 = Dense(dim * 4, dim)

    def forward(self, x, key_mask):
        x = x + self.attn(self.ln1(x), key_mask)
        return x + self.fc2(gelu_tanh_bf16(self.fc1(self.ln2(x))))


class CTCEncoder(nn.Module):
    """log-mel [..., T, M] → frame char logits [..., ceil(T/2), V] float32:
    2×conv (stride 2 on the second) + transformer layers."""

    def __init__(self, vocab_size: int, dim: int = 128, layers: int = 2, heads: int = 4, n_mels: int = 80):
        super().__init__()
        self.dim, self.n_layers, self.heads = dim, layers, heads
        self.conv0 = Conv(n_mels, dim)
        self.conv1 = Conv(dim, dim, stride=2)
        self.pos_emb = nn.Parameter(torch.zeros(4096, dim, dtype=BF16), requires_grad=False)
        self.layers = nn.ModuleList(_Layer(dim, heads) for _ in range(layers))
        self.ln_f = LayerNorm(dim)
        self.head = Dense(dim, vocab_size, dtype=torch.float32)

    def forward(self, mel: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
        """``n_valid`` (downsampled frames) masks the global attention to the
        real frames, so bucket-padded inputs give the same logits on real
        frames as exact-length inputs; None: every frame is real."""
        x = gelu_tanh_bf16(self.conv0(mel))
        x = gelu_tanh_bf16(self.conv1(x))
        T = x.shape[-2]
        idx = torch.arange(T, device=x.device)
        x = x + self.pos_emb[idx % 4096].to(BF16)
        key_mask = None if n_valid is None else idx < int(n_valid)
        for layer in self.layers:
            x = layer(x, key_mask)
        return self.head(self.ln_f(x))


def init_ctc_encoder(model: CTCEncoder, seed: int) -> None:
    """flax's default initialisation of ``CTCEncoder``, drawn in module
    order on the CPU from a generator seeded with ``seed`` (the flax key's
    numbers differ: the parity tests load the converted flax initialisation
    instead): lecun-normal kernels (fan-in k·in for the convolutions),
    zero biases, unit LayerNorm scales, N(0, 1/dim) positions."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                c_out, c_in, k = m.weight.shape
                m.weight.copy_(lecun_normal(k * c_in, (k, c_in, c_out), g).permute(2, 1, 0))
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.kernel.copy_(lecun_normal(m.kernel.shape[0], m.kernel.shape, g))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        model.pos_emb.copy_(embed_normal(model.pos_emb.shape, g))


class CTCAligner:
    """Aligner-protocol implementation. ``frame_dt`` = hop/sr × 2 (conv
    stride). Runs on ``device`` (CUDA by default; a CPU run is asked for with
    ``device="cpu"``)."""

    def __init__(
        self,
        params=None,
        vocab: CharVocab | None = None,
        sample_rate: int = 16000,
        n_mels: int = 80,
        dim: int = 128,
        layers: int = 2,
        weights_path: str | Path | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        dsp_precision()
        self.vocab = vocab or CharVocab()
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.hop = 160
        self.frame_dt = self.hop / sample_rate * 2.0
        self.model = CTCEncoder(vocab_size=len(self.vocab), dim=dim, layers=layers, n_mels=n_mels)
        if weights_path is not None:
            params = load_params(weights_path)
        elif params is None and dim == 128 and layers == 2 and vocab is None and sample_rate == 16000 and n_mels == 80:
            # out-of-the-box default: the packaged checkpoint pretrained on
            # compositional synthetic French speech — the role MFA/NeMo
            # pretrained models play for the reference
            if PACKAGED_WEIGHTS.exists():
                params = load_params(PACKAGED_WEIGHTS)
        self.params = params
        if params is not None:
            self.model.load_state_dict(ctc_params_from_jax(params))
        self.model.to(self.device).eval()

    def init_params(self, seed: int = 0) -> dict:
        """Float32 master weights with flax's default initialisation
        (``init_ctc_encoder``) on the aligner's device; returns (and keeps
        as ``params``) the flax tree of numpy arrays."""
        self.model.cpu()
        master_weights(self.model)
        init_ctc_encoder(self.model, seed)
        self.model.to(self.device)
        self.params = self.flax_params()
        return self.params

    def flax_params(self) -> dict:
        """The encoder's weights as the JAX package's tree (nested, under
        ``params``, float32 numpy)."""
        return nest(ctc_params_to_jax(self.model.state_dict(), heads=self.model.heads))

    # -- feature extraction -------------------------------------------------
    def _samples(self, audio: Audio) -> tuple[Audio, np.ndarray]:
        a16 = audio.to_mono()
        if a16.rate != self.sample_rate:
            a16 = resample(a16, self.sample_rate)
        return a16, np.asarray(a16.samples, np.float32)

    def features(self, audio: Audio) -> torch.Tensor:
        _, x = self._samples(audio)
        xt = torch.from_numpy(x).to(self.device)
        return log_mel(xt, self.sample_rate, n_fft=400, hop_length=self.hop, n_mels=self.n_mels)

    # -- alignment ------------------------------------------------------------
    #: fraction of detected speech that word intervals must cover before
    #: the speech-snap post-pass engages (auto mode)
    COVERAGE_TARGET = 0.90
    #: mean per-frame Viterbi emission log-prob below which the alignment
    #: counts as out-of-distribution
    OOD_SCORE_PER_FRAME = -1.5

    def align(self, audio: Audio, transcript: str | None = None, blank_bias: float | str = "auto") -> TextGrid:
        """Viterbi forced alignment of ``transcript`` to ``audio``.

        Auto mode detects out-of-distribution input by the Viterbi path's
        mean per-frame emission log-prob (``OOD_SCORE_PER_FRAME``) and, when
        the alignment is OOD and its words cover less than
        ``COVERAGE_TARGET`` of the detected speech, ``_snap_to_speech``
        extends words through the in-gap speech, splitting runs at silence.
        In-distribution alignments are never touched. ``blank_bias``: an
        explicit log-penalty subtracted from the blank emission before the
        Viterbi (a float disables auto mode)."""
        if transcript is None:
            raise ValueError("CTCAligner.align needs a transcript (use transcribe for ASR)")
        if self.params is None:
            raise ValueError("CTCAligner has no weights; train or load first")
        words = transcript.split()
        labels, spans = self.vocab.word_spans(words)
        a16, x = self._samples(audio)
        # samples bucket-padded (pow-2, at least 2^14) and labels to 32s, as
        # the JAX package pads them: the Viterbi takes the true lengths, so
        # only the last analysis window sees pad zeros (<= 1 frame)
        n = x.shape[0]
        n_pad = 1 << max(int(n - 1).bit_length(), 14)
        true_frames = self._logits_frames(n)
        l_pad = ((len(labels) + 31) // 32) * 32
        labels_p = np.zeros(l_pad, np.int32)
        labels_p[: len(labels)] = labels
        auto = blank_bias == "auto"
        bias = 0.0 if auto else float(blank_bias)
        states, score = self._align_device(np.pad(x, (0, n_pad - n)), labels_p, true_frames, len(labels), bias)
        states = states[:true_frames]
        triples = states_to_words(states, labels, spans, self.frame_dt, words)
        if auto and score / max(true_frames, 1) < self.OOD_SCORE_PER_FRAME:
            speech = self._speech_mask(a16)
            if self._speech_coverage(speech, triples) < self.COVERAGE_TARGET:
                triples = self._snap_to_speech(triples, speech)
        aligned = [AlignedWord(t0, t1, w) for t0, t1, w in triples]
        return words_to_textgrid(aligned, audio.to_mono().duration_seconds)

    def _logits_frames(self, n_samples: int) -> int:
        """Logits frames for an exact-length input: center-padded STFT gives
        1 + n//hop mel frames; the stride-2 SAME conv halves (ceil)."""
        return (1 + n_samples // self.hop + 1) // 2

    @torch.no_grad()
    def _align_device(self, x: np.ndarray, labels: np.ndarray, n_frames: int, n_labels: int, bias: float):
        """log_mel → encoder (attention masked to the real frames) →
        log-softmax → blank bias → Viterbi, on the aligner's device. Returns
        (states [T] numpy int32, score float)."""
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        mel = log_mel(xt, self.sample_rate, n_fft=400, hop_length=self.hop, n_mels=self.n_mels)
        logits = self.model(mel, n_valid=n_frames)
        logp = torch.log_softmax(logits, dim=-1)
        blank = self.vocab.blank
        logp[:, blank] = logp[:, blank] - torch.tensor(bias, dtype=torch.float32, device=self.device)
        # the labels stay on the host: the Viterbi checks them there and uploads them with its other inputs
        states, score = ctc_forced_align(logp, torch.from_numpy(labels), n_frames, n_labels, blank=blank)
        return states.cpu().numpy(), float(score)

    def _speech_mask(self, a16: Audio) -> np.ndarray:
        """Boolean per-ms detected-speech grid."""
        from ..ops.energy import detect_nonsilent

        x = np.asarray(a16.samples, np.float32)
        length_ms = max(int(len(x) * 1000 / a16.rate), 1)
        grid = np.zeros(length_ms, bool)
        for s, e in detect_nonsilent(x, a16.rate, min_silence_len=180, silence_thresh=-42.0, device=self.device):
            grid[s:e] = True
        return grid

    @staticmethod
    def _speech_coverage(speech: np.ndarray, triples) -> float:
        if not speech.any():
            return 1.0
        word = np.zeros_like(speech)
        for t0, t1, _ in triples:
            word[int(t0 * 1000) : int(t1 * 1000)] = True
        return float((word & speech).sum() / speech.sum())

    #: minimum uncovered speech in a gap (ms) before the snap fills it
    SNAP_MIN_GAP_SPEECH_MS = 30

    @classmethod
    def _snap_to_speech(cls, triples, speech: np.ndarray):
        """Extend word intervals through adjacent in-gap speech: for gaps
        holding >= SNAP_MIN_GAP_SPEECH_MS of uncovered speech, every speech
        ms goes to the nearer word; a silence run inside the gap stays
        unassigned, so the extended boundaries land on silence edges."""
        n_ms = len(speech)

        def gap_speech_ms(a: int, b: int) -> int:
            a, b = max(a, 0), min(b, n_ms)
            return int(speech[a:b].sum()) if b > a else 0

        out = []
        for i, (t0, t1, w) in enumerate(triples):
            s_ms, e_ms = int(t0 * 1000), int(t1 * 1000)
            prev_e = int(triples[i - 1][1] * 1000) if i > 0 else 0
            next_s = int(triples[i + 1][0] * 1000) if i + 1 < len(triples) else n_ms
            j = s_ms
            if gap_speech_ms(prev_e, s_ms) >= cls.SNAP_MIN_GAP_SPEECH_MS or (
                i == 0 and gap_speech_ms(0, s_ms) >= cls.SNAP_MIN_GAP_SPEECH_MS
            ):
                lo = prev_e if i > 0 else 0
                split = (prev_e + s_ms) // 2 if i > 0 else 0
                while j > lo and j - 1 < n_ms and speech[j - 1] and (i == 0 or j > split):
                    j -= 1
            k = e_ms
            if gap_speech_ms(e_ms, next_s) >= cls.SNAP_MIN_GAP_SPEECH_MS:
                hi = next_s if i + 1 < len(triples) else n_ms
                split_f = (e_ms + next_s) // 2 if i + 1 < len(triples) else n_ms
                while k < hi and k < n_ms and speech[k] and (i + 1 == len(triples) or k < split_f):
                    k += 1
            out.append((j / 1000.0, k / 1000.0, w))
        return out

    @torch.no_grad()
    def transcribe(self, audio: Audio) -> str:
        """Greedy CTC decode (collapse repeats, drop blanks)."""
        if self.params is None:
            raise ValueError("CTCAligner has no weights")
        ids = torch.argmax(self.model(self.features(audio)), dim=-1).cpu().numpy()
        out = []
        prev = -1
        for i in ids:
            if i != prev and i != self.vocab.blank:
                out.append(self.vocab.chars[i - 1])
            prev = i
        return "".join(out).strip()

    # -- training ----------------------------------------------------------
    def make_train_step(self, lr: float = 3e-4):
        """The JAX package's train step: Adam (``torch.optim.Adam``, b1 0.9,
        b2 0.999, eps 1e-8 outside the square root, as ``optax.adam``) on
        ``ctc_loss(log_softmax(model(mel)))`` of one utterance, the encoder
        applied with no attention mask. The encoder becomes float32 master
        weights. Returns ``step(mel [T, M], mel_len, labels, label_len) ->
        loss`` (a 0-d tensor on the device); ``mel_len`` counts encoder
        frames, and the labels are read on the host."""
        master_weights(self.model).train()
        opt = torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        blank = self.vocab.blank

        def step(mel: torch.Tensor, mel_len: int, labels, label_len: int) -> torch.Tensor:
            opt.zero_grad(set_to_none=True)
            logp = torch.log_softmax(self.model(mel), dim=-1)
            loss = ctc_loss(logp, labels, mel_len, label_len, blank=blank)
            loss.backward()
            opt.step()
            return loss.detach()

        return step

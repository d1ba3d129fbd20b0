"""Contextual French POS tagger (a small transformer) and the pipeline's POS
backends.

Counterpart of the JAX package's ``models/pos_tagger.py``. It replaces what
the reference gets from spaCy ``fr_core_news_sm``: context-dependent POS for
the pause and comma filters. The closed-class lexicon in ``utils.fr_pos``
answers per token and must commit ambiguous forms to one reading; this
tagger reads the sentence ("il a mangé" AUX vs "il va a paris" ADP, "son
chien" DET vs "le son" NOUN, "or, il pleut" CCONJ vs "l'or" NOUN, ...).

The model is float32 throughout, as the flax one is: LayerNorms with
epsilon 1e-6 and the variance as E[x²] − E[x]² (``models.layers``), the
query scaled by 1/sqrt(head dim) before the score product, masked scores set
to the float32 minimum (not −inf: a padded query row, whose keys are all
masked, gets a uniform softmax instead of NaN), gelu's tanh form. Its
parameters are keyed so that ``convert.pos_tagger_params_from_jax`` maps the
flax tree onto them leaf for leaf; the packaged checkpoint
(``models/pretrained/pos_fr.npz``, float16 leaves under flax's "/"-joined
keys and a JSON ``__meta__``) is a byte-identical copy of the JAX package's,
and ``save_tagger`` writes the same format, so a checkpoint written by one
package loads in the other.

The host side (tokenising with elisions, the hashed character trigrams, the
featuriser, the window plan, the hybrid lexicon/tagger rules) is the JAX
package's, verbatim. A call's windows go through the model as one batch on
the tagger's device, followed by one device→host read of the argmax.
"""

from __future__ import annotations

import json
import math
import re
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import resolve_device
from ..utils import fr_pos
from .layers import LayerNorm
from .pos_data import FORBIDDEN_TAGS, TAG_TO_ID, TAGS, Sentence, strip_accents

__all__ = [
    "PosTaggerConfig",
    "PosTagger",
    "Featurizer",
    "ContextualTagger",
    "PosBackend",
    "get_pos_backend",
    "train_pos_tagger",
    "save_tagger",
    "load_tagger",
    "PACKAGED_WEIGHTS",
]

PACKAGED_WEIGHTS = Path(__file__).parent / "pretrained" / "pos_fr.npz"

MAX_LEN = 32
N_CHAR_BUCKETS = 4096
WEIGHT_DECAY = 1e-4  # optax.adamw's, as the JAX trainer sets it (torch.optim.AdamW's default is 1e-2)

#: forms whose FORBIDDEN bit genuinely depends on context — the hybrid
#: backend consults the contextual tagger ONLY for these and lets the
#: closed-class lexicon answer everything else. Grading on real sentences
#: (tests/goldens/fr_pos_sentences.json) showed the silver-trained tagger
#: drifts on open real-register syntax (it can mis-tag even 'mais'/'par'),
#: while the lexicon is perfect on unambiguous closed-class forms — so
#: each source answers where it is reliable.
AMBIGUOUS_FORMS = {
    "son",  # DET (possessive) vs NOUN (sound)
    "car",  # CCONJ vs NOUN (bus)
    "or",  # CCONJ vs NOUN (gold)
    "personne",  # PRON (nobody) vs NOUN (person)
    "tout",  # DET/PRON vs NOUN/ADV
    "si",  # SCONJ vs ADV (intensifier)
    "soit",  # CCONJ (either) vs AUX (subjunctive être)
    "avant",  # ADP vs ADV
    "après",  # ADP vs ADV
    "a",  # unaccented à (ADP) vs avoir (AUX) in ASR text
}

_ELISION_SPLIT = re.compile(
    r"^([cdjlmnst]['’]|qu['’]|jusqu['’]|lorsqu['’]|puisqu['’]|quoiqu['’])(.+)$",
    re.IGNORECASE,
)


def tokenize_with_elisions(text: str) -> list[str]:
    """fr_pos-compatible tokenization, with elided clitics split off as
    their own tokens ("c'est" → ["c'", "est"]) — the treebank's convention."""
    out = []
    for tok in fr_pos.tokenize(text):
        m = _ELISION_SPLIT.match(tok)
        if m:
            out.append(m.group(1).replace("’", "'").lower())
            out.append(m.group(2))
        else:
            out.append(tok)
    return out


def _norm(tok: str) -> str:
    return tok.strip().lower().replace("’", "'")


def _stable_hash(s: str) -> int:
    # process-independent (Python's str hash is PYTHONHASHSEED-randomised,
    # which would break the packaged checkpoint's featurization)
    return zlib.crc32(s.encode("utf-8"))


def _char_ngrams(tok: str, n: int = 3) -> list[int]:
    s = f"^{_norm(tok)}$"
    if len(s) < n:
        return [_stable_hash(s) % N_CHAR_BUCKETS]
    return [_stable_hash(s[i : i + n]) % N_CHAR_BUCKETS for i in range(len(s) - n + 1)]


@dataclass(frozen=True)
class PosTaggerConfig:
    d_model: int = 96
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 192
    n_tags: int = len(TAGS)
    max_len: int = MAX_LEN
    max_ngrams: int = 12  # char trigrams kept per token


class Featurizer:
    """text/tokens → fixed-shape (word_ids, char_ids, mask) arrays.

    The vocabulary is closed over the training treebank; unseen words map
    to <unk> and are represented by their char-trigram bag — real
    transcripts are full of content words the templates never saw, and
    the forbidden decision for those is always "not a function word",
    which suffix/prefix trigrams carry well in French.
    """

    def __init__(self, vocab: dict[str, int], cfg: PosTaggerConfig):
        self.vocab = vocab
        self.cfg = cfg

    @classmethod
    def build(cls, sentences: list[Sentence], cfg: PosTaggerConfig) -> "Featurizer":
        vocab = {"<pad>": 0, "<unk>": 1}
        for s in sentences:
            for w in s.words:
                w = _norm(w)
                if w not in vocab:
                    vocab[w] = len(vocab)
                ws = strip_accents(w)
                if ws not in vocab:
                    vocab[ws] = len(vocab)
        return cls(vocab, cfg)

    def encode_tokens(self, tokens: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        c = self.cfg
        L = c.max_len
        wid = np.zeros(L, np.int32)
        cid = np.zeros((L, c.max_ngrams), np.int32)
        mask = np.zeros(L, np.float32)
        for i, tok in enumerate(tokens[:L]):
            w = _norm(tok)
            wid[i] = self.vocab.get(w, 1)
            # +1 shift: char-bucket 0 is padding
            for j, g in enumerate(_char_ngrams(w)[: c.max_ngrams]):
                cid[i, j] = g + 1
            mask[i] = 1.0
        return wid, cid, mask

    def encode_batch(self, sents: list[list[str]]):
        enc = [self.encode_tokens(s) for s in sents]
        return (
            np.stack([e[0] for e in enc]),
            np.stack([e[1] for e in enc]),
            np.stack([e[2] for e in enc]),
        )


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class _Dense(nn.Module):
    """flax ``Dense`` in float32, the kernel kept as [in, out]."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class _SelfAttention(nn.Module):
    """flax ``SelfAttention(num_heads, qkv_features=d_model)``: query, key
    and value DenseGenerals [d, heads, hd] flattened to [d, heads·hd], the
    output DenseGeneral [heads, hd, d] flattened to [heads·hd, d]."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (_Dense(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        hd = d // self.heads

        def split(t):  # [B, L, d] → [B, heads, L, hd]
            return t.view(B, L, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        s = torch.matmul(q, k.transpose(-1, -2))  # [B, heads, L, L]
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, v).transpose(1, 2).reshape(B, L, d)
        return self.out(o)


class _Block(nn.Module):
    def __init__(self, c: PosTaggerConfig):
        super().__init__()
        self.ln1 = LayerNorm(c.d_model)
        self.attn = _SelfAttention(c.d_model, c.n_heads)
        self.ln2 = LayerNorm(c.d_model)
        self.fc1 = _Dense(c.d_model, c.d_ff)
        self.fc2 = _Dense(c.d_ff, c.d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


def _trunc_normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """flax's ``variance_scaling(..., "truncated_normal")``: a normal cut at
    ±2 standard deviations, its scale corrected so that the cut one has
    ``std``."""
    s = std / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=gen)


class PosTagger(nn.Module):
    """word_ids [B, L] int, char_ids [B, L, G] int (0 = pad), mask [B, L]
    float → logits [B, L, n_tags], float32.

    Word embedding + the masked mean of the char-trigram embeddings + a
    learned position embedding, ``n_layers`` pre-LN blocks (LayerNorm →
    self-attention → residual, LayerNorm → Dense(d_ff) → gelu → Dense →
    residual), a final LayerNorm and the output Dense.

    ``seed`` draws the weights from a ``torch.Generator`` with flax's
    initialisers' distributions (embeddings and kernels truncated normal at
    1/sqrt(fan-in), the position embedding normal at 0.02, biases 0, the
    LayerNorms 1 and 0); they are not the JAX package's numbers for the same
    seed. ``seed=None`` leaves them for ``load_state_dict``."""

    def __init__(self, cfg: PosTaggerConfig = PosTaggerConfig(), vocab_size: int = 2048, seed: int | None = 0,
                 device="cpu"):
        super().__init__()
        c = self.cfg = cfg
        self.word_embed = nn.Parameter(torch.zeros(vocab_size, c.d_model))
        self.char_embed = nn.Parameter(torch.zeros(N_CHAR_BUCKETS + 1, c.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(c.max_len, c.d_model))
        self.blocks = nn.ModuleList(_Block(c) for _ in range(c.n_layers))
        self.ln_f = LayerNorm(c.d_model)
        self.out = _Dense(c.d_model, c.n_tags)
        self.requires_grad_(True)  # models.layers.LayerNorm is frozen by default
        if seed is not None:
            self._init(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        d = self.cfg.d_model
        _trunc_normal(self.word_embed, d**-0.5, gen)
        _trunc_normal(self.char_embed, d**-0.5, gen)
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, _Dense):
                _trunc_normal(m.kernel, m.kernel.shape[0] ** -0.5, gen)

    def forward(self, word_ids: torch.Tensor, char_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = word_ids.shape[1]
        # F.embedding, not indexing: its backward sums the rows of repeated ids
        # in parallel, where index_put_ adds the ~70 % padding slots of the
        # char ids to one row one after another. Bucket 0 (padding) is masked
        # out of the mean below, so its gradient is 0 either way.
        w = F.embedding(word_ids.long(), self.word_embed)
        ch = F.embedding(char_ids.long(), self.char_embed, padding_idx=0)  # [B, L, G, d]
        ch_mask = (char_ids > 0).float()[..., None]
        ch = (ch * ch_mask).sum(2) / torch.clamp(ch_mask.sum(2), min=1.0)
        x = w + ch + self.pos_embed[None, :L]
        live = mask > 0
        attn_mask = (live[:, :, None] & live[:, None, :])[:, None]  # [B, 1, L, L]
        for blk in self.blocks:
            x = blk(x, attn_mask)
        return self.out(self.ln_f(x))


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


def _loss_fn(logits: torch.Tensor, tags: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tags.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_pos_tagger(cfg: PosTaggerConfig, vocab_size: int, seed: int, device) -> PosTagger:
    """The tagger ``train_pos_tagger`` starts from (tests replace it with the
    JAX package's initialisation, converted)."""
    return PosTagger(cfg, vocab_size=vocab_size, seed=seed, device=device)


def train_pos_tagger(
    sentences: list[Sentence],
    cfg: PosTaggerConfig | None = None,
    steps: int = 500,
    batch_size: int = 256,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 100,
    device="cuda",
    losses: list | None = None,
):
    """Train on the silver treebank; returns (state_dict, featurizer, cfg).

    AdamW as ``optax.adamw(cosine_decay_schedule(lr, steps), weight_decay=
    1e-4)``: b1 0.9, b2 0.999, eps 1e-8, decay on every parameter, the
    learning rate ``lr · ½(1 + cos(π·min(t, steps)/steps))`` at update t
    (1 at the first). The batches and the open-class word dropout draw from
    ``np.random.default_rng(seed)`` in the JAX trainer's order, so a batch
    is the JAX package's. Each step runs on ``device``; a step's loss is read
    back only when it is logged, or appended to ``losses`` when given."""
    dev = resolve_device(device)
    cfg = cfg or PosTaggerConfig()
    feat = Featurizer.build(sentences, cfg)

    toks = [list(s.words) for s in sentences]
    wid, cid, mask = feat.encode_batch(toks)
    tags = np.zeros((len(sentences), cfg.max_len), np.int32)
    for i, s in enumerate(sentences):
        for j, t in enumerate(s.tags[: cfg.max_len]):
            tags[i, j] = TAG_TO_ID[t]
    # word-dropout on OPEN-class tokens: real text is full of content words
    # the templates never saw; training must teach the model to tag them
    # from context + char n-grams alone. Closed classes are never dropped —
    # their identity IS the signal.
    open_tags = np.array(
        [TAG_TO_ID[t] for t in ("NOUN", "VERB", "ADJ", "ADV", "PROPN", "NUM")],
        np.int32,
    )
    droppable = np.isin(tags, open_tags) & (mask > 0)

    rng = np.random.default_rng(seed)
    model = init_pos_tagger(cfg, len(feat.vocab), seed, dev).train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps)))
    cid_d, mask_d, tags_d = (torch.as_tensor(a, device=dev) for a in (cid, mask, tags))

    n = len(sentences)
    for it in range(steps):
        idx = rng.integers(0, n, batch_size)
        bw = wid[idx].copy()
        drop = droppable[idx] & (rng.random(bw.shape) < 0.35)
        bw[drop] = 1  # <unk>
        idx_d = torch.as_tensor(idx, device=dev)
        logits = model(torch.as_tensor(bw, device=dev), cid_d[idx_d], mask_d[idx_d])
        loss = _loss_fn(logits, tags_d[idx_d], mask_d[idx_d])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if losses is not None:
            losses.append(float(loss.detach()))
        if log_every and (it % log_every == 0 or it == steps - 1):
            print(f"pos_tagger step {it}: loss {float(loss.detach()):.4f}", flush=True)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, feat, cfg


def save_tagger(params: dict, feat: Featurizer, cfg: PosTaggerConfig, path: str | Path) -> None:
    """``params``: a ``PosTagger`` state_dict. Written as the JAX package
    writes its checkpoints: float16 leaves under flax's "/"-joined keys and
    the ``__meta__`` JSON (vocabulary and config)."""
    from ..convert import pos_tagger_params_to_jax

    arrays = {k: np.asarray(v, np.float16) for k, v in pos_tagger_params_to_jax(params, cfg).items()}
    meta = {
        "vocab": feat.vocab,
        "cfg": {k: getattr(cfg, k) for k in (
            "d_model", "n_heads", "n_layers", "d_ff", "n_tags", "max_len", "max_ngrams"
        )},
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_tagger(path: str | Path = PACKAGED_WEIGHTS):
    """→ (state_dict, Featurizer, PosTaggerConfig), float32; raises
    FileNotFoundError if the checkpoint is absent."""
    from ..convert import pos_tagger_params_from_jax

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: np.asarray(z[k], np.float32) for k in z.files if k != "__meta__"}
    cfg = PosTaggerConfig(**meta["cfg"])
    return pos_tagger_params_from_jax(arrays), Featurizer(meta["vocab"], cfg), cfg


# ---------------------------------------------------------------------------
# inference and the pipeline's backends
# ---------------------------------------------------------------------------


class ContextualTagger:
    """Inference wrapper: whole-sentence tagging on the tagger's device.

    Long inputs are tagged in overlapping MAX_LEN windows (stride
    ``max_len - 2*overlap``); each token takes its label from the window
    where it sits furthest from the edges, so every decision has context
    on both sides.
    """

    _OVERLAP = 8

    def __init__(self, params: dict | None = None, feat: Featurizer | None = None, cfg=None, device="cuda"):
        self.device = resolve_device(device)
        if params is None:
            params, feat, cfg = load_tagger()
        self.feat = feat
        self.cfg = cfg
        self.model = PosTagger(cfg, vocab_size=len(feat.vocab), seed=None, device=self.device).eval()
        self.model.load_state_dict(params)
        self._cache: dict[tuple, tuple[str, ...]] = {}

    def logits(self, wid: np.ndarray, cid: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """The model on featurised windows, on the tagger's device."""
        with torch.inference_mode():
            return self.model(*(torch.as_tensor(a, device=self.device) for a in (wid, cid, mask)))

    def tag_tokens(self, tokens: list[str]) -> list[str]:
        if not tokens:
            return []
        key = tuple(_norm(t) for t in tokens)
        hit = self._cache.get(key)
        if hit is not None:
            return list(hit)
        L, ov = self.cfg.max_len, self._OVERLAP
        stride = L - 2 * ov
        if len(tokens) <= L:
            windows = [(0, tokens)]
        else:
            windows = []
            s = 0
            while s < len(tokens):
                windows.append((s, tokens[s : s + L]))
                if s + L >= len(tokens):
                    break
                s += stride
        wid, cid, mask = self.feat.encode_batch([w for _, w in windows])
        pred = self.logits(wid, cid, mask).argmax(-1).cpu().numpy()
        out = [""] * len(tokens)
        best_center = [-1.0] * len(tokens)
        for (s, wtoks), row in zip(windows, pred):
            for j in range(len(wtoks)):
                # distance from the nearer window edge = available context
                centrality = min(j, len(wtoks) - 1 - j)
                if centrality > best_center[s + j]:
                    best_center[s + j] = centrality
                    out[s + j] = TAGS[int(row[j])]
        if len(self._cache) > 512:
            self._cache.clear()
        self._cache[key] = tuple(out)
        return out

    def tag_text(self, text: str) -> list[tuple[str, str]]:
        toks = tokenize_with_elisions(text)
        return list(zip(toks, self.tag_tokens(toks)))

    def is_function_word_at(self, tokens: list[str], i: int) -> bool:
        return self.tag_tokens(tokens)[i] in FORBIDDEN_TAGS

    def make_pos_of(self, words: list[str]):
        """Closure for ``ssml.syntagme`` hooks: tags the WHOLE word
        sequence once, then answers per-token queries POSITIONALLY.
        The pause filter passes the word index of each query (it only asks
        about words directly preceding a pause, so token matching alone
        cannot tell repeated occurrences apart); the index resolves the
        exact occurrence. Index-less queries fall back to a monotonic
        forward scan from a pointer that each closure keeps for itself."""
        # each "word" from the textgrid may be multi-token; the filters ask
        # about the first token (fr_pos.first_token_pos semantics)
        first_toks: list[tuple[int, str]] = []
        flat: list[str] = []
        for w in words:
            toks = tokenize_with_elisions(w.strip()) or [""]
            first_toks.append((len(flat), toks[0]))
            flat.extend(toks)
        tags = self.tag_tokens(flat) if flat else []
        norm_first = [_norm(tok) for _, tok in first_toks]
        ptr = 0

        def pos_of(query: str, word_index: int | None = None) -> str:
            nonlocal ptr
            toks = tokenize_with_elisions(query.strip())
            if not toks:
                return "X"
            q = _norm(toks[0])
            if q not in AMBIGUOUS_FORMS:
                # hybrid: the lexicon is authoritative off the ambiguous set
                if word_index is not None:
                    ptr = max(ptr, word_index + 1)
                return fr_pos.first_token_pos(query)
            if word_index is not None and 0 <= word_index < len(norm_first):
                if norm_first[word_index] == q:
                    ptr = word_index + 1
                    tag = tags[first_toks[word_index][0]]
                    return tag if tag in FORBIDDEN_TAGS else "X"
                # index/token mismatch (caller cleaned differently) —
                # fall through to the scan
            # scan forward from the pointer: queried words arrive in
            # sequence order
            for i in range(ptr, len(norm_first)):
                if norm_first[i] == q:
                    ptr = i + 1
                    tag = tags[first_toks[i][0]]
                    return tag if tag in FORBIDDEN_TAGS else "X"
            # unseen query (e.g. cleaned differently) — fall back
            return fr_pos.first_token_pos(query)

        return pos_of

    def remove_spurious_commas(self, text: str) -> str:
        """Contextual twin of ``fr_pos.remove_spurious_commas`` — same span
        splice; the forbidden bit comes from the sentence-level tags for
        AMBIGUOUS_FORMS and from the lexicon everywhere else (hybrid)."""
        matches = list(fr_pos._TOKEN_RE.finditer(text))
        toks = []
        tok_of_match = []
        for m in matches:
            sub = tokenize_with_elisions(m.group(0))
            tok_of_match.append((len(toks), len(sub)))
            toks.extend(sub)
        tags = self.tag_tokens(toks) if toks else []
        removed_spans: list[tuple[int, int]] = []
        prev_forbidden = False
        for m, (ti, tn) in zip(matches, tok_of_match):
            tok = m.group(0)
            if (tok == "," or tok == "[*]") and prev_forbidden:
                removed_spans.append((m.start(), m.end()))
                continue
            if tok == "[" and text[m.start() : m.start() + 3] == "[*]" and prev_forbidden:
                removed_spans.append((m.start(), m.start() + 3))
                continue
            if tok.strip():
                if tok[0].isalnum() or "'" in tok:
                    last = ti + tn - 1
                    if tags and _norm(toks[last]) in AMBIGUOUS_FORMS:
                        prev_forbidden = tags[last] in FORBIDDEN_TAGS
                    else:
                        prev_forbidden = fr_pos.pos_tag(toks[last]) in fr_pos.FORBIDDEN
                else:
                    prev_forbidden = False
        if not removed_spans:
            return text
        res = []
        last = 0
        for s, e in removed_spans:
            res.append(text[last:s])
            if e < len(text) and text[e] == " " and (s > 0 and text[s - 1] == " "):
                e += 1
            last = e
        res.append(text[last:])
        return "".join(res)


@dataclass(frozen=True)
class PosBackend:
    """What the pipeline consumes: per-token POS for chunk heads, the comma
    filter, and (contextual only) a sentence-aware pos_of factory for the
    syntagme pause filter (None → per-token default)."""

    first_token_pos: object
    remove_spurious_commas: object
    pos_of_factory: object = None


def get_pos_backend(name: str, device="cuda") -> PosBackend:
    """Config hook: "lexicon" (default) → fr_pos functions; "contextual" →
    the packaged tagger on ``device`` (the lexicon needs none)."""
    if name == "lexicon":
        return PosBackend(fr_pos.first_token_pos, fr_pos.remove_spurious_commas)
    if name == "contextual":
        tagger = ContextualTagger(device=device)

        def first_token_pos(text: str) -> str:
            toks = tokenize_with_elisions(text.strip())
            if not toks:
                return "X"
            if _norm(toks[0]) not in AMBIGUOUS_FORMS:
                return fr_pos.first_token_pos(text)  # hybrid: lexicon rules
            tag = tagger.tag_tokens(toks)[0]
            return tag if tag in FORBIDDEN_TAGS else "X"

        return PosBackend(first_token_pos, tagger.remove_spurious_commas, tagger.make_pos_of)
    raise ValueError(f"unknown pos backend: {name!r} (use 'lexicon' or 'contextual')")

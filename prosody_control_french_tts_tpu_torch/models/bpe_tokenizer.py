"""Byte-level BPE tokenizer + Whisper vocabulary converter.

The reference's primary aligner loads a published Whisper model whose
tokenizer is a GPT-2-style byte-level BPE with Whisper's special tokens
(Code/Aligners/use_whisper_timestamped.py:92-104 — works out of the box).
This module makes ``aligner: whisper`` deployable here:

- ``ByteLevelBPE``: a from-scratch byte-level BPE encoder/decoder (GPT-2
  pretokenisation, byte↔unicode table, rank-ordered merges);
- converters for every format the published vocabularies ship in:
  HF ``tokenizer.json``, ``vocab.json`` + ``merges.txt``, and OpenAI's
  ``*.tiktoken`` rank files (base64 token + rank per line);
- the multilingual Whisper special-token table (eot 50257, sot 50258,
  99 language tokens — ``<|fr|>`` = 50265 — task/timestamps) so ported
  checkpoints decode real ids;
- ``synthetic_multilingual()``: a degenerate byte-level vocabulary with the
  full 51865-id geometry for hermetic tests (every byte is its own token,
  so any text round-trips without the published merge table).

The tokenizer satisfies the aligner protocol (``cls_id``/``sep_id``/
``encode``/``decode``/``pieces_with_boundaries``) used by
align.whisper.WhisperAligner.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

# Whisper's language-token order (openai/whisper tokenizer; public table).
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()

MULTILINGUAL_BASE = 50257  # BPE ranks 0..50256
TIMESTAMP_COUNT = 1501  # <|0.00|> .. <|30.00|> in 0.02 s steps
MULTILINGUAL_VOCAB = 51865


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def gpt2_pretokenize(text: str) -> list[str]:
    """The GPT-2 pretokeniser pattern, as an explicit scanner (Python `re`
    has no \\p{L}; `str.isalpha`/`isnumeric` stand in for the unicode
    categories): contractions | ` ?letters+` | ` ?numbers+` | ` ?other+` |
    trailing-whitespace | whitespace."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        hit = None
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                hit = c
                break
        if hit:
            out.append(hit)
            i += len(hit)
            continue
        j = i
        prefix = ""
        if text[j] == " " and j + 1 < n and not text[j + 1].isspace():
            prefix = " "
            j += 1
        c = text[j]
        if c.isalpha():
            k = j
            while k < n and text[k].isalpha():
                k += 1
        elif c.isnumeric():
            k = j
            while k < n and text[k].isnumeric():
                k += 1
        elif not c.isspace():
            k = j
            while k < n and not text[k].isspace() and not text[k].isalpha() and not text[k].isnumeric():
                k += 1
        else:  # whitespace run
            k = i
            while k < n and text[k].isspace():
                k += 1
            if k < n and k - i > 1:
                # \s+(?!\S): keep the final space for the next token
                out.append(text[i : k - 1])
                i = k - 1
            else:
                out.append(text[i:k])
                i = k
            continue
        out.append(prefix + text[j:k])
        i = k
    return out


@dataclass
class ByteLevelBPE:
    """Byte-level BPE over a rank-ordered vocabulary.

    ``merges`` may be empty: pairs then merge whenever their concatenation
    exists in the vocabulary, preferring the lowest merged-token rank —
    exactly the tiktoken formulation, which needs no separate merge table.
    """

    vocab: dict[str, int]  # byte-unicode token string → id
    merges: dict[tuple[str, str], int] = field(default_factory=dict)
    specials: dict[str, int] = field(default_factory=dict)
    eot_token: str = "<|endoftext|>"
    sot_token: str = "<|startoftranscript|>"

    def __post_init__(self):
        self._inv = {i: t for t, i in self.vocab.items()}
        self._inv_special = {i: t for t, i in self.specials.items()}
        b2u = bytes_to_unicode()
        self._byte_enc = b2u
        self._byte_dec = {v: k for k, v in b2u.items()}
        self._cache: dict[str, list[str]] = {}

    # -- protocol properties (aligner expects BERT-style names) ----------
    @property
    def cls_id(self) -> int:
        return self.specials[self.sot_token]

    @property
    def sep_id(self) -> int:
        return self.specials[self.eot_token]

    @property
    def pad_id(self) -> int:
        return self.sep_id  # Whisper pads with eot

    def __len__(self) -> int:
        n = max(
            max(self.vocab.values(), default=-1),
            max(self.specials.values(), default=-1),
        )
        return n + 1

    def lang_id(self, lang: str = "fr") -> int:
        return self.specials[f"<|{lang}|>"]

    def sot_sequence(self, lang: str = "fr", task: str = "transcribe", timestamps: bool = False) -> list[int]:
        seq = [self.cls_id, self.lang_id(lang), self.specials[f"<|{task}|>"]]
        if not timestamps:
            seq.append(self.specials["<|notimestamps|>"])
        return seq

    # -- BPE --------------------------------------------------------------
    def _rank(self, a: str, b: str) -> float:
        if self.merges:
            return self.merges.get((a, b), float("inf"))
        return self.vocab.get(a + b, float("inf"))

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            best_rank = float("inf")
            best_i = -1
            for i in range(len(word) - 1):
                r = self._rank(word[i], word[i + 1])
                if r < best_rank and (word[i] + word[i + 1]) in self.vocab:
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]
        self._cache[token] = word
        return word

    def encode_text(self, text: str) -> list[int]:
        """Text → BPE ids (no specials)."""
        ids: list[int] = []
        for tok in gpt2_pretokenize(text):
            s = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(s):
                pid = self.vocab.get(piece)
                if pid is None:  # unseen symbol → per-byte fallback
                    ids.extend(self.vocab[ch] for ch in piece if ch in self.vocab)
                else:
                    ids.append(pid)
        return ids

    def encode(self, text: str) -> list[int]:
        """[sot] + text ids + [eot] — the aligner strips the frame with
        ``[1:-1]`` (the WordPiece [CLS]/[SEP] convention)."""
        return [self.cls_id] + self.encode_text(text) + [self.sep_id]

    def _token_bytes(self, tid: int) -> bytes:
        t = self._inv.get(tid)
        if t is None:
            return b""
        return bytes(self._byte_dec[c] for c in t)

    def decode(self, ids: list[int]) -> str:
        buf = b"".join(self._token_bytes(i) for i in ids if i not in self._inv_special)
        return buf.decode("utf-8", errors="replace").strip()

    def pieces_with_boundaries(self, ids: list[int]) -> list[str]:
        """Per-token surface strings where a leading space marks a word
        start — the aligner's grouping contract. Byte-level BPE carries the
        space inside the token; an *incremental* UTF-8 decode assigns each
        multi-byte character to the token that completes it, so word marks
        concatenate losslessly (accented French words span token joins)."""
        import codecs

        dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        out = []
        for i in ids:
            if i in self._inv_special:
                out.append("")
                continue
            out.append(dec.decode(self._token_bytes(i)))
        return out

    # -- persistence -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(
                {
                    "vocab": self.vocab,
                    "merges": [[a, b] for (a, b) in sorted(self.merges, key=self.merges.get)],
                    "specials": self.specials,
                },
                ensure_ascii=False,
            ),
            encoding="utf-8",
        )

    @classmethod
    def load(cls, path: str | Path) -> "ByteLevelBPE":
        d = json.loads(Path(path).read_text(encoding="utf-8"))
        return cls(
            vocab=d["vocab"],
            merges={(a, b): i for i, (a, b) in enumerate(d["merges"])},
            specials=d["specials"],
        )


def whisper_specials(base: int = MULTILINGUAL_BASE) -> dict[str, int]:
    """The multilingual Whisper special-token table starting at ``base``."""
    names = ["<|endoftext|>", "<|startoftranscript|>"]
    names += [f"<|{l}|>" for l in WHISPER_LANGUAGES]
    names += [
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
    ]
    names += [f"<|{i * 0.02:.2f}|>" for i in range(TIMESTAMP_COUNT)]
    return {n: base + i for i, n in enumerate(names)}


# ---------------------------------------------------------------------------
# converters for the published vocabulary formats
# ---------------------------------------------------------------------------


def from_vocab_and_merges(vocab_json: str | Path, merges_txt: str | Path) -> ByteLevelBPE:
    """GPT-2-style ``vocab.json`` + ``merges.txt`` (openai/whisper-* repos)."""
    raw = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
    vocab = {t: i for t, i in raw.items() if not (t.startswith("<|") and t.endswith("|>"))}
    merges: dict[tuple[str, str], int] = {}
    for line in Path(merges_txt).read_text(encoding="utf-8").splitlines():
        if not line or line.startswith("#version"):
            continue
        a, _, b = line.partition(" ")
        merges[(a, b)] = len(merges)
    base = max(vocab.values()) + 1
    return ByteLevelBPE(vocab=vocab, merges=merges, specials=whisper_specials(base))


def from_hf_tokenizer_json(path: str | Path) -> ByteLevelBPE:
    """HF ``tokenizer.json`` (model.vocab + model.merges + added_tokens)."""
    d = json.loads(Path(path).read_text(encoding="utf-8"))
    model = d["model"]
    vocab = {
        t: i for t, i in model["vocab"].items() if not (t.startswith("<|") and t.endswith("|>"))
    }
    merges: dict[tuple[str, str], int] = {}
    for k, m in enumerate(model.get("merges", [])):
        a, b = (m.split(" ", 1) if isinstance(m, str) else m)
        merges[(a, b)] = k
    specials = {t["content"]: t["id"] for t in d.get("added_tokens", [])}
    if "<|endoftext|>" not in specials:
        specials.update(whisper_specials(max(vocab.values()) + 1))
    # fill in any table entries the added_tokens list omits (timestamps)
    base = specials.get("<|endoftext|>", max(vocab.values()) + 1)
    for name, tid in whisper_specials(base).items():
        specials.setdefault(name, tid)
    return ByteLevelBPE(vocab=vocab, merges=merges, specials=specials)


def from_tiktoken(path: str | Path) -> ByteLevelBPE:
    """OpenAI ``multilingual.tiktoken``-style rank file: one
    ``base64(token_bytes) rank`` pair per line. Ranks double as the merge
    order (no separate merge table in this format)."""
    b2u = bytes_to_unicode()
    vocab: dict[str, int] = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        tok_b64, rank = line.split()
        token = base64.b64decode(tok_b64)
        vocab["".join(b2u[b] for b in token)] = int(rank)
    base = max(vocab.values()) + 1
    return ByteLevelBPE(vocab=vocab, merges={}, specials=whisper_specials(base))


def load_whisper_tokenizer(path: str | Path) -> ByteLevelBPE:
    """Dispatch on whatever vocabulary artifact the deployment provides:
    a directory (probes the known filenames), ``tokenizer.json``,
    ``vocab.json`` (+ sibling ``merges.txt``), or ``*.tiktoken``."""
    p = Path(path)
    if p.is_dir():
        if (p / "tokenizer.json").exists():
            return from_hf_tokenizer_json(p / "tokenizer.json")
        if (p / "vocab.json").exists() and (p / "merges.txt").exists():
            return from_vocab_and_merges(p / "vocab.json", p / "merges.txt")
        tiks = sorted(p.glob("*.tiktoken"))
        if tiks:
            return from_tiktoken(tiks[0])
        saved = sorted(p.glob("*.bpe.json"))
        if saved:
            return ByteLevelBPE.load(saved[0])
        raise FileNotFoundError(f"no tokenizer artifact under {p}")
    if p.suffix == ".tiktoken":
        return from_tiktoken(p)
    name = p.name
    if name == "vocab.json":
        return from_vocab_and_merges(p, p.parent / "merges.txt")
    if name.endswith(".bpe.json"):
        return ByteLevelBPE.load(p)
    return from_hf_tokenizer_json(p)


def byte_level_french(base: int = 256) -> ByteLevelBPE:
    """Compact byte-level vocabulary for the hermetically-pretrained French
    Whisper checkpoint (align.pretrain_whisper): the 256 byte symbols are
    the only text tokens (1 byte = 1 token — ideal for the compositional
    per-character synthetic speech of align.synth_speech), with the full
    Whisper special-token table at ``base``. Total vocab 1864 ids — small
    enough to ship embedding weights in-repo. Any text round-trips."""
    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    return ByteLevelBPE(vocab=vocab, merges={}, specials=whisper_specials(base))


def synthetic_multilingual() -> ByteLevelBPE:
    """Full 51865-id geometry without the published merge table: the 256
    byte symbols are the only real tokens (ids 0-255), fillers pad the BPE
    range, specials sit at their published ids. Any text round-trips —
    enough to exercise the full-geometry model + pipeline hermetically."""
    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for i in range(256, MULTILINGUAL_BASE):
        vocab[f"<unused_{i}>"] = i
    return ByteLevelBPE(vocab=vocab, merges={}, specials=whisper_specials(MULTILINGUAL_BASE))

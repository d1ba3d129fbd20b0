"""The legacy BDD chain's math, stage by stage.

Reference stages (SURVEY.md §3.2):

- ``extract_segment_rows``      Code/Pipeline/extract_process_segments.py:7-59
  (TextGrid tier → per-interval rows)
- ``align_rows``                Code/Pipeline/NeedlemanWunschAlignement.py:27-84
  (NW global alignment, gap rows)
- ``add_breaks``                Code/Pipeline/Ajuster_les_pauses.py:39-49
  (0.01 s pauses at gap rows → BDD1)
- ``compute_pitch_adjustments`` Code/Pipeline/compute_pitch_adjustments.py:131-340
  (per-syntagme geometric-mean pitch with multi-floor retry 75/100/150/200,
  relative modification vs ≤50-sentence means → BDD2)
- ``compute_loudness_adjustments`` Code/Pipeline/compute_loudness_adjustments.py:8-65
  (RMS-dB loudness, %Δ clipped ±20 → BDD3)
- ``compute_rate_adjustments``  Code/Pipeline/compute_rate_adjustments.py:30-65
  (words/minute, %Δ clipped ±100 → BDD4)
- ``build_ssml_fragments``      Code/Pipeline/Get_Wav.py:8-122
  (power-law compression rate^0.80 / pitch^0.5, pause÷3 clamp [1,500] ms,
  breath hints, per-segment <speak> assembly → BDD5)

Pitch runs on the batched Boersma tracker (``ops.pitch.praat_pitch`` on
``device``: kernels A and B on the card) instead of per-slice Praat calls:
one track per (file × floor), geometric means by window masking on the host.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..ops.kernels import resolve_device
from ..ops.pitch import PitchParams, praat_pitch
from ..utils.textgridio import TextGrid, read_textgrid
from ..utils.wavio import read_wav
from .needleman import nw_align_rows

PITCH_FLOORS = (75.0, 100.0, 150.0, 200.0)  # compute_pitch_adjustments.py:191


@dataclass
class SegmentRow:
    """One aligned word/pause interval of a (natural, synthesized) pair —
    the structured form of the reference's regex-parsed CSV rows
    ('file: text (start-end, dur)')."""

    file: str
    text: str
    start: float
    end: float
    natural_file: str | None = None
    synthesized_file: str | None = None
    begin_natural: float = 0.0
    end_natural: float = 0.0
    begin_synthesized: float = 0.0
    end_synthesized: float = 0.0
    is_gap_natural: bool = False
    is_gap_synthesized: bool = False

    @property
    def is_pause(self) -> bool:
        return not self.text.strip()

    @property
    def duration_natural(self) -> float:
        return max(self.end_natural - self.begin_natural, 0.0)

    @property
    def duration_synthesized(self) -> float:
        return max(self.end_synthesized - self.begin_synthesized, 0.0)


def extract_segment_rows(tg: TextGrid | str, file_name: str, wav_path: str | None = None) -> list[dict]:
    """TextGrid first tier → [{PhraseID, Start, End, Duration, Text, File}]
    (extract_process_segments.py:7-59 CSV schema; File carries the wav
    path the pitch/loudness stages slice)."""
    if isinstance(tg, (str, Path)):
        tg = read_textgrid(tg)
    rows = []
    for i, iv in enumerate(tg.tiers[0]):
        rows.append(
            {
                "PhraseID": f"{file_name}_segment_{i}",
                "Start": iv.min_time,
                "End": iv.max_time,
                "Duration": iv.duration,
                "Text": iv.mark.strip(),
                "File": wav_path,
            }
        )
    return rows


def align_rows(natural: list[dict], synthesized: list[dict]) -> list[SegmentRow]:
    """Needleman-Wunsch over the word sequences; gaps become rows with the
    counterpart's timing and a 0-duration hole (NW gap rows
    ('-','',0,0,0), NeedlemanWunschAlignement.py:74-78)."""
    return nw_align_rows(natural, synthesized)


def add_breaks(rows: list[SegmentRow], gap_pause_s: float = 0.01) -> list[SegmentRow]:
    """Insert the artificial 0.01 s pauses at alignment gaps
    (Ajuster_les_pauses.py:39-46) — in-place semantics on the row list."""
    out = []
    for r in rows:
        if r.is_gap_natural or r.is_gap_synthesized:
            pause = SegmentRow(
                file=r.file,
                text="",
                start=r.start,
                end=r.start + gap_pause_s,
                natural_file=r.natural_file,
                synthesized_file=r.synthesized_file,
                begin_natural=r.begin_natural,
                end_natural=r.begin_natural + (gap_pause_s if r.is_gap_synthesized else 0.0),
                begin_synthesized=r.begin_synthesized,
                end_synthesized=r.begin_synthesized + (gap_pause_s if r.is_gap_natural else 0.0),
            )
            out.append(pause)
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# syntagme grouping (compute_pitch_adjustments.construct_syntagmes:70-128)
# ---------------------------------------------------------------------------


@dataclass
class LegacySyntagme:
    syntagme: str
    begin_natural: float
    end_natural: float
    duration_natural: float
    begin_synthesized: float
    end_synthesized: float
    duration_synthesized: float
    pause_natural: float
    pause_synthesized: float
    natural_file: str | None
    synthesized_file: str | None
    # filled by later stages
    natural_pitch: float = 0.0
    synthesized_pitch: float = 0.0
    pitch_adjustment: float = 0.0
    relative_pitch_pct: float = 0.0
    natural_loudness: float = 0.0
    synthesized_loudness: float = 0.0
    loudness_adjustment: float = 0.0
    word_count: int = 0
    rate_natural: float = 0.0
    rate_synthesized: float = 0.0
    rate_adjustment: float = 0.0

    @property
    def is_pause(self) -> bool:
        return not self.syntagme.strip()


def construct_syntagmes(rows: list[SegmentRow]) -> list[LegacySyntagme]:
    """Group word runs between pauses; each pause is its own empty
    syntagme carrying the pause durations."""
    synts: list[LegacySyntagme] = []
    run: list[SegmentRow] = []

    def flush():
        if not run:
            return
        synts.append(
            LegacySyntagme(
                syntagme=" ".join(r.text for r in run if r.text),
                begin_natural=run[0].begin_natural,
                end_natural=run[-1].end_natural,
                duration_natural=sum(r.duration_natural for r in run),
                begin_synthesized=run[0].begin_synthesized,
                end_synthesized=run[-1].end_synthesized,
                duration_synthesized=sum(r.duration_synthesized for r in run),
                pause_natural=0.0,
                pause_synthesized=0.0,
                natural_file=run[0].natural_file,
                synthesized_file=run[0].synthesized_file,
            )
        )
        run.clear()

    for r in rows:
        if r.is_pause:
            flush()
            synts.append(
                LegacySyntagme(
                    syntagme="",
                    begin_natural=r.begin_natural,
                    end_natural=r.end_natural,
                    duration_natural=0.0,
                    begin_synthesized=r.begin_synthesized,
                    end_synthesized=r.end_synthesized,
                    duration_synthesized=0.0,
                    pause_natural=r.duration_natural or 0.01,
                    pause_synthesized=r.duration_synthesized or 0.01,
                    natural_file=r.natural_file,
                    synthesized_file=r.synthesized_file,
                )
            )
        else:
            run.append(r)
    flush()
    return synts


# ---------------------------------------------------------------------------
# BDD2: pitch (geometric mean, multi-floor retry)
# ---------------------------------------------------------------------------


class _PitchCache:
    """One Boersma track per (file, floor) on ``device``, windows answered
    by masking on the host — the kernel-friendly replacement for per-slice
    Praat invocations."""

    def __init__(self, device="cuda"):
        self.device = device
        self.tracks: dict[tuple[str, float], tuple[np.ndarray, np.ndarray]] = {}

    def geometric_mean_pitch(self, path: str | None, t0: float, t1: float) -> float:
        if not path or not Path(path).exists() or t0 >= t1:
            return 0.0
        for floor in PITCH_FLOORS:
            key = (str(path), floor)
            if key not in self.tracks:
                a = read_wav(path).to_mono()
                tr = praat_pitch(
                    np.asarray(a.samples, np.float32),
                    a.rate,
                    PitchParams(floor=floor, ceiling=600.0),
                    device=self.device,
                )
                self.tracks[key] = (tr.f0.cpu().numpy(), tr.times)
            f0, times = self.tracks[key]
            sel = f0[(times >= t0) & (times <= t1) & (f0 > 0)]
            if sel.size > 0:
                return float(np.exp(np.mean(np.log(sel))))
        return 0.0


def compute_pitch_adjustments(
    synts: list[LegacySyntagme], max_sentences_for_mean: int = 50, device="cuda"
) -> list[LegacySyntagme]:
    """BDD2 numerics (compute_pitch_adjustments.py:210-335):

    - per-syntagme geometric-mean pitch (multi-floor retry);
    - pitch_adjustment = (nat − syn)/syn·100, clipped ±100, 0 for pauses;
    - per-file non-zero means; corpus means over the first ≤50 active
      sentences; relative modification
      (syn/μ_syn)/(nat/μ_nat) → percent (x−1)·100.

    The pitch tracks run on ``device``.
    """
    cache = _PitchCache(resolve_device(device))
    for s in synts:
        if s.is_pause:
            continue
        s.natural_pitch = cache.geometric_mean_pitch(s.natural_file, s.begin_natural, s.end_natural)
        s.synthesized_pitch = cache.geometric_mean_pitch(
            s.synthesized_file, s.begin_synthesized, s.end_synthesized
        )
        if s.synthesized_pitch != 0:
            adj = (s.natural_pitch - s.synthesized_pitch) / s.synthesized_pitch * 100.0
            s.pitch_adjustment = float(np.clip(adj, -100, 100))

    # per-file means over non-zero syntagme pitches
    def file_means(attr_file: str, attr_pitch: str) -> dict[str, float]:
        byf: dict[str, list[float]] = {}
        for s in synts:
            f = getattr(s, attr_file)
            v = getattr(s, attr_pitch)
            if f and v != 0:
                byf.setdefault(f, []).append(v)
        return {f: float(np.mean(v)) for f, v in byf.items()}

    nat_means = file_means("natural_file", "natural_pitch")
    syn_means = file_means("synthesized_file", "synthesized_pitch")

    # corpus means over the first ≤50 "active" sentences
    nat_seq = [nat_means[f] for f in dict.fromkeys(s.natural_file for s in synts if s.natural_file) if f in nat_means]
    syn_seq = [syn_means[f] for f in dict.fromkeys(s.synthesized_file for s in synts if s.synthesized_file) if f in syn_means]
    mean_nat = float(np.mean(nat_seq[:max_sentences_for_mean])) if nat_seq else 0.0
    mean_syn = float(np.mean(syn_seq[:max_sentences_for_mean])) if syn_seq else 0.0

    for s in synts:
        if s.is_pause or not mean_nat or not mean_syn:
            continue
        adj_syn = s.synthesized_pitch / mean_syn if s.synthesized_pitch else 0.0
        adj_nat = s.natural_pitch / mean_nat if s.natural_pitch else 0.0
        rel = adj_syn / adj_nat if adj_nat else 0.0
        s.relative_pitch_pct = (rel - 1.0) * 100.0 if rel else 0.0
    return synts


# ---------------------------------------------------------------------------
# BDD3: loudness (RMS dB), BDD4: rate (words/min)
# ---------------------------------------------------------------------------


def _rms_db(path: str | None, t0: float, t1: float) -> float:
    """RMS of int-scale samples → 20·log10 (compute_loudness_adjustments.py:8-25;
    pydub int16 semantics)."""
    if not path or not Path(path).exists():
        return 0.0
    a = read_wav(path).to_mono().slice_ms(t0 * 1000, t1 * 1000)
    if a.samples.size == 0:
        return 0.0
    s = a.int_samples()
    rms = math.sqrt(float(np.mean(np.square(s))))
    return 20.0 * math.log10(rms) if rms > 0 else 0.0


def compute_loudness_adjustments(synts: list[LegacySyntagme]) -> list[LegacySyntagme]:
    eps = 1e-6
    for s in synts:
        if s.is_pause:
            continue
        s.natural_loudness = _rms_db(s.natural_file, s.begin_natural, s.end_natural)
        s.synthesized_loudness = _rms_db(s.synthesized_file, s.begin_synthesized, s.end_synthesized)
        if abs(s.synthesized_loudness) > eps:
            s.loudness_adjustment = float(
                np.clip(
                    (s.natural_loudness - s.synthesized_loudness) / s.synthesized_loudness * 100.0,
                    -20,
                    20,
                )
            )
    return synts


def compute_rate_adjustments(synts: list[LegacySyntagme]) -> list[LegacySyntagme]:
    for s in synts:
        if s.is_pause:
            continue
        s.word_count = len([w for w in s.syntagme.split() if w.strip()])
        dn = s.duration_natural / 60.0
        ds = s.duration_synthesized / 60.0
        s.rate_natural = s.word_count / dn if dn > 0 else 0.0
        s.rate_synthesized = s.word_count / ds if ds > 0 else 0.0
        if s.rate_synthesized > 0:
            adj = (s.rate_natural - s.rate_synthesized) / s.rate_synthesized * 100.0
            s.rate_adjustment = float(np.clip(adj, -100, 100))
    return synts


# ---------------------------------------------------------------------------
# BDD5: SSML fragments (Get_Wav.py:8-122)
# ---------------------------------------------------------------------------

PAUSE_COEF = 1.0
MAX_PAUSE_MS = 500
MIN_PAUSE_MS = 1


def _compress(value: float, power: float) -> float:
    return float(np.sign(value) * np.abs(value) ** power)


def ssml_fragment(
    text: str,
    pitch_adj: float,
    rate_adj: float,
    loudness_adj: float,
    pause_natural_s: float,
    style: str | None = None,
    styledegree: str | None = None,
) -> str:
    """One fragment with the reference's power-law compression and pause
    clamping (Get_Wav.create_ssml_fragment:8-67)."""
    if not str(text).strip():
        pause_ms = pause_natural_s * 1000.0 / 3.0
        if not pause_ms:
            pause_ms = MAX_PAUSE_MS
        else:
            pause_ms *= PAUSE_COEF
            pause_ms = min(max(pause_ms, MIN_PAUSE_MS), MAX_PAUSE_MS)
        return f"<break time='{int(pause_ms)}ms'/>"

    rate_adj = min(2.0, _compress(rate_adj, 0.80))
    pitch_adj = _compress(pitch_adj, 0.5)
    pitch_mod = f"{pitch_adj:+.2f}%" if pitch_adj else "+0%"
    rate_mod = f"{rate_adj:+.2f}%" if rate_adj else "+0%"
    loud_mod = f"{loudness_adj:+.2f}%" if loudness_adj else "+0%"

    clean = re.sub(r"[\x00-\x1F\x7F]", "", str(text))
    clean = clean.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    if clean.endswith((",", "ß")):
        clean = clean[:-1] + ", h"  # breath hint
    elif clean.endswith("!"):
        clean = clean[:-1] + "! h"
    elif clean.endswith("?"):
        clean = clean[:-1] + "? h"

    body = f"<prosody pitch='{pitch_mod}' rate='{rate_mod}' volume='{loud_mod}'>{clean}</prosody>"
    if style:
        return f"<mstts:express-as style='{style}' styledegree='{styledegree}'>{body}</mstts:express-as>"
    return body


def build_ssml_fragments(
    synts: list[LegacySyntagme], voice: str, style: str | None = None, styledegree: str | None = None
) -> list[dict]:
    """Per-segment <speak> assembly (Get_Wav.get_wav:69-122). Segment id
    comes from the natural (else synthesized) file's segment_ph number."""

    def seg_of(s: LegacySyntagme) -> int:
        for f in (s.natural_file, s.synthesized_file):
            if f and "segment_ph" in str(f):
                m = re.search(r"segment_ph(\d+)", str(f))
                if m:
                    return int(m.group(1))
        return -10

    rows = []
    last = -1
    for s in synts:
        seg = seg_of(s)
        if seg == -10:
            seg = last
        last = seg
        rows.append(
            (
                seg,
                s.syntagme if s.syntagme else " ",
                ssml_fragment(
                    s.syntagme,
                    s.relative_pitch_pct,
                    s.rate_adjustment,
                    s.loudness_adjustment,
                    s.pause_natural,
                    style,
                    styledegree,
                ),
            )
        )

    out = []
    by_seg: dict[int, list[tuple[str, str]]] = {}
    for seg, syn, frag in rows:
        by_seg.setdefault(seg, []).append((syn, frag))
    for seg, items in by_seg.items():
        if seg == -1:
            continue
        text = "".join(s for s, _ in items).strip()
        content = " ".join(f for _, f in items)
        ssml = (
            "<speak version='1.0' xmlns='http://www.w3.org/2001/10/synthesis' "
            "xmlns:mstts='http://www.w3.org/2001/mstts' xml:lang='fr-FR'>"
            f"<voice name='{voice}'>{content}</voice></speak>"
        )
        out.append({"segment": seg, "syntagme": text, "ssml": ssml})
    return out

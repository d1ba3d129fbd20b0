"""Prosody measurement of one voice, or of every voice at once, in PyTorch.

Port of the JAX package's ``prosody/measure.py``. The whole voice is loaded
into two padded corpora (natural [S, T], raw synthetic [S, T2]); two eager
device passes on one stream compute

- the natural side: the F0 track of every segment (Boersma frames, kernel A
  for the candidates, kernel B for the path), the voiced median in every
  syntagme window and over each segment, and gated LUFS of every syntagme
  window with the full-file fallback;
- the raw side: the same gated LUFS.

``measure_voices_batched`` runs the same passes once per (padded length,
rate) group over every voice of a corpus, the voices concatenated on the
segment axis (the multi-voice pipeline, ``core.batch_runner``).

Durations, word counts and the clamp/smooth math run on the host
(``prosody.adjust``); host work is otherwise file I/O, TextGrid parsing and
syntagme bookkeeping. Corpora are read through the native ingest
(``utils.native_audio``: one target rate, the windowed-sinc resampler,
int16 straight from PCM16 files), and the pipeline prefetches them
(:class:`CorpusPrefetch`): loaded, and on a card uploaded, before the
measure step asks for them. Lengths are padded to ``bucket_length``
buckets: the F0 frame grid is centred over the padded buffer, so the bucket
rule is kept exactly as the JAX package's to keep the same frames.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core.profiling import phase
from ..ops import pcm
from ..ops.kernels import dsp_precision, on_device, resolve_device
from ..ops.loudness import k_weight, max_blocks_for, windowed_loudness
from ..ops.pitch import PitchParams, PitchTrack, _geometry, _pitch_frames, median_pitch_in_windows, viterbi_batched
from ..ops.rangemax import RangeMax
from ..parallel.mesh import production_data_mesh
from ..ssml.syntagme import Syntagme, extract_words_and_pauses, pipeline_syntagmes
from ..utils import fr_pos, native_audio
from ..utils.textgridio import read_textgrid
from ..utils.wavio import read_wav, resample, wav_info
from .adjust import ProsodySettings, pitch_adjust_pct, rate_adjust_pct, segment_baselines, smooth_series, volume_adjust_pct


def bucket_length(n: int, minimum: int = 1 << 15) -> int:
    """Next (2^k − 8192) ≥ n (≥ minimum): few distinct shapes for ragged
    segments, and exactly the K-weighting filter's 8192-sample decay pad so
    the loudness FFT lands on a power of two."""
    m = minimum
    while m - 8192 < n:
        m *= 2
    return m - 8192


_SEG_NUM = re.compile(r"segment_ph(\d+)")


def segment_sort_key(p: Path):
    """Numeric order of ``segment_ph<i>`` files (``segment_ph10`` after
    ``segment_ph2``); other names after them, by name."""
    m = _SEG_NUM.search(p.stem)
    return (0, int(m.group(1))) if m else (1, p.stem)


@dataclass
class MeasureRow:
    segment: str
    syntagme: str
    pause: int
    raw_pitch: float
    raw_volume: float
    raw_rate: float
    pitch_smooth: float = 0.0
    rate_smooth: float = 0.0


@dataclass
class SegmentStat:
    segment: str
    p_nat: float
    l_nat: float
    l_syn: float
    d_nat: float
    d_syn: float
    wc: int
    rate_ratio: float


@dataclass
class MeasureResult:
    rows: list[MeasureRow]
    seg_stats: list[SegmentStat]
    baselines: dict[str, np.ndarray] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# device passes
# ---------------------------------------------------------------------------


def _pitch_part(nat, nat_len, win_nat, mask, rate: float, T: int, pp: PitchParams):
    """Natural-side pitch: frames, candidates, path, windowed medians.
    Returns (p_syn [S, N], p_seg [S])."""
    g = _geometry(T, rate, pp)
    freq, strength, intensity, _ = _pitch_frames(nat, rate, T, pp, nat_len.to(torch.float32))
    f0 = viterbi_batched(freq, strength, intensity, pp, g["dt"])  # [S, F]
    times = g["first_time"] + np.arange(g["n_frames"]) * g["dt"]
    track = PitchTrack(f0=f0, times=times, dt=g["dt"])
    p_syn = median_pitch_in_windows(track, win_nat.to(torch.float32) / rate, mask)
    full_win = torch.stack([torch.zeros_like(nat_len), nat_len], dim=-1).to(torch.float32) / rate
    p_seg = median_pitch_in_windows(track, full_win[:, None, :])[:, 0]
    return p_syn, p_seg


def _lufs_part(x, x_len, wins, rate: float, max_t: int):
    """Windowed gated LUFS with the full-file fallback column."""
    y = k_weight(x, rate, num_samples=max_t)
    rmax = RangeMax.build(x)
    # the full-file window rides as one extra column, so one windowed pass
    # serves the fallback too
    fw = torch.stack([torch.zeros_like(x_len), x_len], dim=-1)[:, None, :]
    wins_ext = torch.cat([wins, fw], dim=1)  # [S, N+1, 2]
    peaks = rmax.query(wins_ext[..., 0], wins_ext[..., 1])
    peaks = torch.where(peaks > 0, peaks, torch.ones((), dtype=peaks.dtype, device=peaks.device))
    lufs_ext, valid_ext = windowed_loudness(
        y, rate, wins_ext[..., 0], wins_ext[..., 1], peaks, max_blocks=max_blocks_for(max_t, rate)
    )
    minus70 = torch.full((), -70.0, dtype=lufs_ext.dtype, device=lufs_ext.device)
    flufs = torch.where(valid_ext[:, -1], lufs_ext[:, -1], minus70)
    out = torch.where(valid_ext[:, :-1], lufs_ext[:, :-1], flufs[:, None])
    return out, flufs


def _as_f32(a: torch.Tensor) -> torch.Tensor:
    return pcm.i16_to_f32(a) if a.dtype == torch.int16 else a


def measure_nat(nat, nat_len, win_nat, mask, rate: float, T: int, pp: PitchParams):
    """Natural side: (p_syn, p_seg, l_nat_syn, l_nat_seg)."""
    nat = _as_f32(nat)
    p_syn, p_seg = _pitch_part(nat, nat_len, win_nat, mask, rate, T, pp)
    l_syn, l_seg = _lufs_part(nat, nat_len, win_nat, rate, T)
    return p_syn, p_seg, l_syn, l_seg


def measure_raw(raw, raw_len, win_raw, rate: float, T2: int):
    """Raw side: (l_raw_syn, l_raw_seg)."""
    return _lufs_part(_as_f32(raw), raw_len, win_raw, rate, T2)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


def _load_padded(paths, rate_expect=None):
    """Read wavs (None: a missing file) → ([S, T] padded corpus — int16
    when that image is exact, else float32 — lengths, rate, ok-flags).

    When every item is a path, the native ingest reads them
    (``utils.native_audio``): one target rate for the whole corpus
    (``rate_expect``, else the first readable file's), each file resampled
    to it by the windowed sinc, the stride the bucket of the longest file
    counted in output samples; mono PCM16 at that rate is copied as int16,
    anything else decoded to float32. A file that cannot be read gets length
    0. A None item sends the corpus through the Python path (``read_wav``,
    scipy's resampler), where a missing file gets length 1."""
    items = list(paths)
    if items and all(isinstance(p, (str, Path)) for p in items):
        return _load_native(items, rate_expect)
    sigs, ok = [], []
    rate = rate_expect
    for item in items:
        if item is None:
            sigs.append(np.zeros(1, np.float32))
            ok.append(False)
            continue
        try:
            a = read_wav(item).to_mono()
        except (FileNotFoundError, ValueError):
            sigs.append(np.zeros(1, np.float32))
            ok.append(False)
            continue
        if rate is None:
            rate = a.rate
        elif a.rate != rate:
            a = resample(a, rate)
        sigs.append(np.asarray(a.samples, np.float32))
        ok.append(True)
    T = bucket_length(max(s.shape[0] for s in sigs))
    out = np.zeros((len(sigs), T), np.float32)
    lens = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        out[i, : s.shape[0]] = s
        lens[i] = s.shape[0]
    return _as_int16_if_lossless(out), lens, rate or 44100, np.asarray(ok)


def _load_native(paths: list, rate_expect=None):
    """``_load_padded`` of a corpus of paths, through the native ingest."""
    sizes, rates = [], []
    for p in paths:
        try:
            frames, file_rate = wav_info(p)  # the headers only
        except (ValueError, OSError):
            frames, file_rate = 1, 0
        sizes.append(frames)
        rates.append(file_rate)
    valid_rates = [r for r in rates if r > 0]
    # an explicit target always: a mixed-rate corpus is resampled to one
    # rate, and the stride counts output samples (the loader resamples
    # before it clips to the stride)
    target = int(rate_expect or (valid_rates[0] if valid_rates else 0))
    if target:
        sizes = [int(np.ceil(f * target / r)) if r and r != target else f for f, r in zip(sizes, rates)]
    T = bucket_length(max(sizes))
    res16 = native_audio.load_batch_i16(paths, stride=T, target_rate=target)
    if res16 is not None:
        batch, lens, rate = res16
        return batch, lens, rate, np.asarray(lens > 0)
    batch, lens, rate = native_audio.load_batch(paths, stride=T, target_rate=target)
    return _as_int16_if_lossless(batch), lens, rate, np.asarray(lens > 0)


def _as_int16_if_lossless(out: np.ndarray) -> np.ndarray:
    """The int16 image of the corpus when that conversion is exact; the
    device casts back, so results are unchanged and the upload halves."""
    q = pcm.f32_to_i16_exact(out)
    return out if q is None else q


def _ms_to_samp(ms: float, rate: int) -> int:
    return int(ms * rate / 1000.0)


# ---------------------------------------------------------------------------
# corpus prefetch
# ---------------------------------------------------------------------------


@dataclass
class Resident:
    """A corpus or segment image on a device. On a card it was copied (or
    assembled) on the device's copy stream: ``event`` marks the end of that
    work, and ``pinned``, the host image it was copied from, is kept for as
    long as the entry lives. On the CPU it is the host array itself."""

    tensor: torch.Tensor
    event: object = None
    pinned: object = None

    def ready(self) -> torch.Tensor:
        """The tensor, safe to read on its device's current stream (which
        waits on ``event``; the tensor, allocated on the copy stream, is
        recorded on the current one)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


def _corpus_key(paths, rate_expect):
    """(path, mtime, size) of every file and the target rate: a rewritten
    file misses."""
    items = []
    for p in paths:
        if p is None:
            items.append(None)
            continue
        try:
            st = Path(p).stat()
        except OSError:
            items.append((str(p), -1, -1))
            continue
        items.append((str(p), st.st_mtime_ns, st.st_size))
    return (tuple(items), int(rate_expect or 0))


def _device_key(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class CorpusPrefetch:
    """Corpora and segments loaded (and, on a card, uploaded) before the
    measure step asks for them. The pipeline calls :func:`prefetch_corpus`
    the moment a corpus is final on disk and :func:`prefetch_segment` after
    each raw segment is written: the host load runs in the step that makes
    the files, and the upload, on a copy stream, runs behind the steps that
    follow. ``prepare_voice`` then takes the host arrays and the resident
    image from here (:func:`_load_padded_cached`).

    Entries are keyed by (path, mtime, size) of every file and the target
    rate, at most ``CORPUS_CAP`` corpora and ``SEGMENT_CAP`` segments, the
    oldest evicted first. ``hits`` and ``misses`` count the consumer's
    look-ups, ``assembled`` the corpora built on the device from resident
    segment rows."""

    # two corpora a voice for eight voices
    CORPUS_CAP = 16
    SEGMENT_CAP = 64

    def __init__(self):
        self.corpora: dict = {}  # key -> ((batch, lens, rate, ok), Resident | None)
        self.segments: dict = {}  # key -> (samples, Resident of the bucketed int16 row)
        self.streams: dict = {}  # card -> its copy stream
        self.hits = self.misses = self.assembled = 0

    def clear(self) -> None:
        self.corpora.clear()
        self.segments.clear()
        self.hits = self.misses = self.assembled = 0

    def upload(self, a: np.ndarray, dev: torch.device) -> Resident:
        """``a`` on ``dev``: a copy from pinned memory on the card's copy
        stream, or the host array itself on the CPU."""
        if dev.type != "cuda":
            return Resident(torch.from_numpy(a))
        pinned = torch.from_numpy(a).pin_memory()
        stream = self._stream(dev)
        with on_device(dev), torch.cuda.stream(stream):
            t = pinned.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return Resident(t, event, pinned)

    def stack(self, rows: list, width: int, dev: torch.device) -> Resident:
        """The resident rows as one zero-padded [S, width] int16 image,
        built on the card's copy stream after the rows' own copies."""
        if dev.type != "cuda":
            out = torch.zeros((len(rows), width), dtype=torch.int16)
            for i, r in enumerate(rows):
                out[i, : r.tensor.shape[0]] = r.tensor
            return Resident(out)
        stream = self._stream(dev)
        with on_device(dev), torch.cuda.stream(stream):
            out = torch.zeros((len(rows), width), dtype=torch.int16, device=dev)
            for i, r in enumerate(rows):
                out[i, : r.tensor.shape[0]].copy_(r.tensor)
            event = torch.cuda.Event()
            event.record(stream)
        return Resident(out, event)

    def _stream(self, dev: torch.device):
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        return self.streams[dev]

    @staticmethod
    def put(table: dict, cap: int, key, value) -> None:
        while len(table) >= cap:
            table.pop(next(iter(table)))
        table[key] = value


PREFETCH = CorpusPrefetch()


def prefetch_segment(path, rate_expect=None, device="cuda") -> None:
    """Load one wav and start its upload to ``device``, right after a
    synthesis loop writes it; :func:`prefetch_corpus` then assembles the
    corpus from the resident rows on the device. Only mono PCM16 at the
    target rate (``rate_expect``, else the file's) is taken: a file that
    cannot be read, or needs a resample or a decode, is left to the corpus
    load."""
    dev = _device_key(resolve_device(device))
    key = _corpus_key([path], rate_expect)
    if key in PREFETCH.segments:
        return
    try:
        frames, file_rate = wav_info(path)
    except (ValueError, OSError):
        return
    target = int(rate_expect or file_rate)
    if not target or file_rate != target:
        return
    res = native_audio.load_batch_i16([path], stride=bucket_length(frames), target_rate=target)
    if res is None:
        return
    row, lens, _ = res
    PREFETCH.put(PREFETCH.segments, PREFETCH.SEGMENT_CAP, key, (int(lens[0]), PREFETCH.upload(row[0], dev)))


def _assemble_from_segments(paths, host, rate_expect, dev: torch.device):
    """The [S, T] corpus image on ``dev`` from resident segment rows, or None
    unless the host load is int16, every row is resident there (an int16
    load at the same rate: the same bytes) with the host load's length, and
    the production data mesh is off (its slots take their rows from the
    host)."""
    if production_data_mesh(dev) is not None:
        return None
    batch, lens, _rate, _ok = host
    if batch.dtype != np.int16:
        return None
    rows = []
    for p, n in zip(paths, lens):
        hit = PREFETCH.segments.get(_corpus_key([p], rate_expect))
        if hit is None or hit[0] != int(n) or hit[1].tensor.device != dev:
            return None
        rows.append(hit[1])
    T = batch.shape[1]
    if any(r.tensor.shape[0] > T for r in rows):
        return None
    PREFETCH.assembled += 1
    return PREFETCH.stack(rows, T, dev)


def prefetch_corpus(paths, rate_expect=None, device="cuda") -> None:
    """Load a wav corpus as ``_load_padded`` does and start its upload to
    ``device`` (nothing on a repeat call for unchanged files). When every
    segment is resident (:func:`prefetch_segment`), the padded image is
    assembled on the device instead of uploaded. Under the production data
    mesh only the host arrays are kept."""
    paths = list(paths)
    dev = _device_key(resolve_device(device))
    key = _corpus_key(paths, rate_expect)
    if not paths or key in PREFETCH.corpora:
        return
    host = _load_padded(paths, rate_expect=rate_expect)
    res = _assemble_from_segments(paths, host, rate_expect, dev)
    if res is None and production_data_mesh(dev) is None:
        res = PREFETCH.upload(host[0], dev)
    PREFETCH.put(PREFETCH.corpora, PREFETCH.CORPUS_CAP, key, (host, res))


def _load_padded_cached(paths, rate_expect=None):
    """(batch, lens, rate, ok, Resident or None): a prefetched corpus when
    its files are unchanged, else ``_load_padded``."""
    hit = PREFETCH.corpora.get(_corpus_key(list(paths), rate_expect))
    if hit is not None:
        PREFETCH.hits += 1
        (batch, lens, rate, ok), res = hit
        return batch, lens, rate, ok, res
    PREFETCH.misses += 1
    batch, lens, rate, ok = _load_padded(paths, rate_expect=rate_expect)
    return batch, lens, rate, ok, None


@dataclass
class PreparedVoice:
    """Host-side arrays for one voice, ready for the device passes."""

    names: list
    raw_seqs: list
    synts_per_seg: list
    nat: np.ndarray
    nat_len: np.ndarray
    rate: int
    raw_ok: np.ndarray
    raw_len: np.ndarray
    raw_for_device: np.ndarray
    raw_len_dev: np.ndarray
    win_nat: np.ndarray
    win_raw: np.ndarray
    win_raw_dev: np.ndarray
    mask: np.ndarray
    raw_slice_empty: np.ndarray
    # prefetched images of nat / raw_for_device (Resident), set only where
    # the host array is used as loaded (no promotion, no fallback rewrite)
    nat_dev: Resident | None = None
    raw_dev: Resident | None = None


def prepare_voice(
    seg_files: list[Path],
    textgrid_dir: Path,
    raw_audio_dir: Path,
    settings: ProsodySettings,
    clean_word=None,
    pos_of_factory=None,
) -> PreparedVoice:
    """Everything before the device passes: TextGrid parsing, syntagme
    construction, padded corpus loading, window and fallback bookkeeping."""
    if clean_word is None:
        clean_word = fr_pos.remove_spurious_commas

    names = [p.stem for p in seg_files]
    with phase("measure/prepare/textgrids"):
        tgs = [read_textgrid(textgrid_dir / f"{n}.TextGrid") for n in names]
        raw_seqs = [extract_words_and_pauses(tg) for tg in tgs]
        synts_per_seg: list[list[Syntagme]] = [
            pipeline_syntagmes(
                tg, settings.end_punctuation_pause_ms, clean_word=clean_word, pos_of_factory=pos_of_factory
            )
            for tg in tgs
        ]

    with phase("measure/prepare/load_nat"):
        nat, nat_len, rate, _, nat_dev = _load_padded_cached(seg_files)
    raw_paths = [raw_audio_dir / f"{n}.wav" for n in names]
    with phase("measure/prepare/load_raw"):
        raw, raw_len, _, raw_ok, raw_dev = _load_padded_cached(
            [p if p.exists() else None for p in raw_paths], rate_expect=rate
        )
    if nat.dtype != raw.dtype:
        # an int16 image must never mix with float32: promote the int16 side
        # (its prefetched image no longer matches)
        if nat.dtype == np.int16:
            nat, nat_dev = pcm.i16_to_f32(nat), None
        if raw.dtype == np.int16:
            raw, raw_dev = pcm.i16_to_f32(raw), None

    S = len(names)
    N = max(1, max(len(s) for s in synts_per_seg))
    N = ((N + 15) // 16) * 16  # bucket the syntagme axis too
    win_nat = np.zeros((S, N, 2), np.int32)
    win_raw = np.zeros((S, N, 2), np.int32)
    mask = np.zeros((S, N), bool)
    raw_slice_empty = np.zeros((S, N), bool)
    for i, synts in enumerate(synts_per_seg):
        for j, syn in enumerate(synts):
            i0 = _ms_to_samp(syn.start_ms, rate)
            i1 = _ms_to_samp(syn.end_ms, rate)
            i0n, i1n = min(i0, int(nat_len[i])), min(i1, int(nat_len[i]))
            win_nat[i, j] = (i0n, max(i1n, i0n))
            # raw slice at natural times; empty → whole raw file
            r0, r1 = min(i0, int(raw_len[i])), min(i1, int(raw_len[i]))
            if r1 <= r0 or not raw_ok[i]:
                raw_slice_empty[i, j] = True
                win_raw[i, j] = (0, int(raw_len[i]))
            else:
                win_raw[i, j] = (r0, r1)
            mask[i, j] = True

    # a missing raw file falls back to the natural slice (reference
    # Code/audioPipeline.py:506-509): point its raw windows at the natural
    # signal
    raw_for_device = raw if raw_ok.all() else raw.copy()
    raw_len_dev = raw_len.copy()
    win_raw_dev = win_raw.copy()
    T2 = raw.shape[1]
    if (~raw_ok).any():
        raw_dev = None  # the rewrite below leaves the prefetched image behind
        if nat.shape[1] > T2:
            raw_for_device = np.zeros((S, nat.shape[1]), raw.dtype)
            raw_for_device[:, :T2] = raw
        for i in range(S):
            if not raw_ok[i]:
                raw_for_device[i, : int(nat_len[i])] = nat[i, : int(nat_len[i])]
                raw_for_device[i, int(nat_len[i]) :] = 0
                raw_len_dev[i] = nat_len[i]
                win_raw_dev[i] = win_nat[i]

    return PreparedVoice(
        names=names,
        raw_seqs=raw_seqs,
        synts_per_seg=synts_per_seg,
        nat=nat,
        nat_len=nat_len,
        rate=rate,
        raw_ok=raw_ok,
        raw_len=raw_len,
        raw_for_device=raw_for_device,
        raw_len_dev=raw_len_dev,
        win_nat=win_nat,
        win_raw=win_raw,
        win_raw_dev=win_raw_dev,
        mask=mask,
        raw_slice_empty=raw_slice_empty,
        nat_dev=nat_dev,
        raw_dev=raw_dev,
    )


run_measure_device_calls = 0  # calls of the per-voice device pass


def _slots(dev: torch.device) -> list:
    """The devices a measure pass splits its segment rows over: the
    production data mesh (``parallel.mesh.production_data_mesh``), else
    ``dev`` alone."""
    return production_data_mesh(dev) or [dev]


def _measure_on_slots(g: dict, rate: float, pp: PitchParams, slots) -> list:
    """A group's seven tensors (``g``) measured over the slots: the segment
    axis padded with zero rows to a multiple of the slots, each slot's
    contiguous block of rows measured on its device with that device
    current, the work of every slot enqueued before any read. One slot
    measures ``g`` as it lies. Returns the slots' packed outputs
    (:func:`_pack6`); the caller reads the first S rows only."""
    S = g["nat"].shape[0]
    per = -(-S // len(slots))

    def block(t, i, sdev):
        part = t[i * per : (i + 1) * per]
        if part.shape[0] < per:
            part = torch.cat([part, part.new_zeros((per - part.shape[0],) + tuple(part.shape[1:]))])
        return part.to(sdev)

    parts = []
    for i, sdev in enumerate(slots):
        with on_device(sdev):
            b = {k: block(g[k], i, sdev) for k in ("nat", "nat_len", "win_nat", "mask", "raw", "raw_len", "win_raw")}
            with phase("measure/device/nat"):
                nat_out = measure_nat(b["nat"], b["nat_len"], b["win_nat"], b["mask"], rate, g["T"], pp)
            with phase("measure/device/raw"):
                raw_out = measure_raw(b["raw"], b["raw_len"], b["win_raw"], rate, g["T2"])
            parts.append(_pack6((*nat_out, *raw_out)))
    return parts


def _read_rows(parts: list, S: int) -> np.ndarray:
    """The first S rows of the slots' packed outputs, on the host."""
    return np.concatenate([p.cpu().numpy() for p in parts])[:S]


def _pack_dev(slots) -> torch.device:
    """Where a group is packed: on the one slot's device, else on the host
    (each slot takes its block from there)."""
    return slots[0] if len(slots) == 1 else torch.device("cpu")


def run_measure_device(prep: PreparedVoice, pp: PitchParams, device="cuda"):
    """The two device passes (natural side, then raw side), eager on one
    stream. Returns the six host arrays (p_syn, p_seg, l_nat_syn,
    l_nat_seg, l_raw_syn, l_raw_seg). Under the production data mesh
    (``parallel.mesh.production_data_mesh``) the segment rows are split over
    its devices."""
    global run_measure_device_calls
    run_measure_device_calls += 1
    dsp_precision()
    slots = _slots(resolve_device(device))
    with phase("measure/device/to_device"):
        g = _pack_group([(None, prep)], _pack_dev(slots))
    parts = _measure_on_slots(g, float(prep.rate), pp, slots)
    with phase("measure/device/wait"):
        return _unpack6(_read_rows(parts, prep.nat.shape[0]))


def postprocess_voice(prep: PreparedVoice, outputs, settings: ProsodySettings) -> MeasureResult:
    """Segment stats, baselines, adjustments and smoothing, on the host."""
    p_syn, p_seg, l_nat_syn, l_nat_seg, l_raw_syn, l_raw_seg = outputs
    names, raw_seqs, synts_per_seg = prep.names, prep.raw_seqs, prep.synts_per_seg
    nat_len, raw_len, raw_ok, rate = prep.nat_len, prep.raw_len, prep.raw_ok, prep.rate
    win_nat, win_raw, win_raw_dev = prep.win_nat, prep.win_raw, prep.win_raw_dev

    # segment stats + baselines (Code/audioPipeline.py:363-424)
    seg_stats: list[SegmentStat] = []
    for i, name in enumerate(names):
        wc = sum(1 for k, t, _ in raw_seqs[i] if k == "word" and t and t.strip())
        d_nat = float(nat_len[i]) / rate or 1e-4
        d_syn = (float(raw_len[i]) / rate or 1e-4) if raw_ok[i] else d_nat
        l_syn_seg_val = float(l_raw_seg[i]) if raw_ok[i] else float(l_nat_seg[i])
        rate_ratio = (wc / d_nat) / (wc / d_syn) if wc > 0 and d_syn > 0 else 1.0
        seg_stats.append(
            SegmentStat(
                segment=name, p_nat=float(p_seg[i]), l_nat=float(l_nat_seg[i]), l_syn=l_syn_seg_val,
                d_nat=d_nat, d_syn=d_syn, wc=wc, rate_ratio=rate_ratio,
            )
        )
    baselines = segment_baselines(
        np.array([s.p_nat for s in seg_stats]),
        np.array([s.l_nat for s in seg_stats]),
        np.array([s.rate_ratio for s in seg_stats]),
        settings.baseline_window,
    )

    # per-syntagme raw adjustments over the flat row axis
    # (Code/audioPipeline.py:437-589)
    meta = [(i, j, syn) for i, synts in enumerate(synts_per_seg) for j, syn in enumerate(synts)]
    if not meta:
        return MeasureResult(rows=[], seg_stats=seg_stats, baselines=baselines)
    idx_i = np.array([m[0] for m in meta])
    idx_j = np.array([m[1] for m in meta])
    pause_s = np.array([m[2].pause_ms for m in meta], np.float64) / 1000.0
    wc_syn = np.array([m[2].word_count for m in meta], np.float64)
    nat_total = (win_nat[idx_i, idx_j, 1] - win_nat[idx_i, idx_j, 0]) / rate
    nat_total = np.where(nat_total == 0, 1e-4, nat_total)
    empty = prep.raw_slice_empty[idx_i, idx_j]
    raw_present = raw_ok[idx_i]
    eff_win_raw = np.where(empty[:, None], win_raw_dev[idx_i, idx_j], win_raw[idx_i, idx_j])
    syn_total = (eff_win_raw[:, 1] - eff_win_raw[:, 0]) / rate
    # a decoded raw file whose window lies past its end: the reference's
    # get_part_duration gives 1e-4 for the empty slice
    syn_total = np.where(empty & raw_present, 1e-4, syn_total)
    syn_total = np.where(syn_total == 0, 1e-4, syn_total)
    d_nat = np.maximum(nat_total - pause_s, 1e-4)
    d_syn = np.maximum(syn_total - pause_s, 1e-4)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    p_pct = pitch_adjust_pct(
        f32(p_syn[idx_i, idx_j]), f32(baselines["f0"][idx_i]), settings.pitch_semitones, settings.pitch_lower_clip_factor
    )
    v_pct = volume_adjust_pct(f32(baselines["loud"][idx_i]), f32(l_raw_syn[idx_i, idx_j]), settings.volume_pct)
    r_pct = rate_adjust_pct(f32(wc_syn), f32(d_nat), f32(d_syn), settings)
    # smoothing across the whole voice (Code/audioPipeline.py:592-602)
    sm_p = smooth_series(p_pct.numpy(), settings.smoothing_alpha, settings.max_jump_percent).numpy()
    sm_r = smooth_series(r_pct.numpy(), settings.smoothing_alpha, settings.max_jump_percent).numpy()
    p_pct, v_pct, r_pct = p_pct.numpy(), v_pct.numpy(), r_pct.numpy()

    rows = [
        MeasureRow(
            segment=names[i],
            syntagme=syn.words,
            pause=int(syn.pause_ms),
            raw_pitch=float(p_pct[k]),
            raw_volume=float(v_pct[k]),
            raw_rate=float(r_pct[k]),
            pitch_smooth=float(sm_p[k]),
            rate_smooth=float(sm_r[k]),
        )
        for k, (i, j, syn) in enumerate(meta)
    ]
    return MeasureResult(rows=rows, seg_stats=seg_stats, baselines=baselines)


def measure_voice(
    seg_files: list[Path],
    textgrid_dir: Path,
    raw_audio_dir: Path,
    settings: ProsodySettings,
    pitch_params: PitchParams | None = None,
    clean_word=None,
    pos_of_factory=None,
    device="cuda",
) -> MeasureResult:
    """The measure stage of one voice (SSML emission is in
    ``core.pipeline``)."""
    resolve_device(device)
    pp = pitch_params or PitchParams()
    with phase("measure/prepare"):
        prep = prepare_voice(seg_files, textgrid_dir, raw_audio_dir, settings, clean_word, pos_of_factory)
    with phase("measure/device"):
        outputs = run_measure_device(prep, pp, device)
    with phase("measure/postprocess"):
        return postprocess_voice(prep, outputs, settings)


# ---------------------------------------------------------------------------
# every voice of a corpus at once
# ---------------------------------------------------------------------------


def _pack6(outs) -> torch.Tensor:
    """The six measure outputs as one [S, 3N+3] buffer, so a group is read
    back to the host in one copy. Columns: p_syn | p_seg | l_nat_syn |
    l_nat_seg | l_raw_syn | l_raw_seg."""
    p_syn, p_seg, l_nat_syn, l_nat_seg, l_raw_syn, l_raw_seg = outs
    return torch.cat(
        [p_syn, p_seg[:, None], l_nat_syn, l_nat_seg[:, None], l_raw_syn, l_raw_seg[:, None]], dim=1
    )


def _unpack6(arr: np.ndarray):
    """Host: inverse of _pack6. arr [S, 3N+3] → the six output arrays."""
    n = (arr.shape[1] - 3) // 3
    return (
        arr[:, :n],
        arr[:, n],
        arr[:, n + 1 : 2 * n + 1],
        arr[:, 2 * n + 1],
        arr[:, 2 * n + 2 : 3 * n + 2],
        arr[:, 3 * n + 2],
    )


def _pack_group(items, dev: torch.device):
    """One group's voices on the device, concatenated on the segment axis:
    audio padded to the group's T and T2 (int16 kept only when every voice
    of the group has it), windows and mask padded to the group's N. A
    voice's prefetched image (``PreparedVoice.nat_dev`` / ``raw_dev``) takes
    the place of its upload where it lies on ``dev`` with the host array's
    shape and dtype."""
    dev_key = _device_key(dev)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    def pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
        if t.shape[1] == n:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) + tuple(t.shape[2:]))], dim=1)

    def image(a: np.ndarray, res: Resident | None) -> torch.Tensor:
        if res is not None and res.tensor.device == dev_key and tuple(res.tensor.shape) == a.shape \
                and res.tensor.dtype == torch.from_numpy(a[:0]).dtype:
            return res.ready()
        return put(a)

    def audio(pairs, width):
        mixed = len({a.dtype for a, _ in pairs}) > 1
        return torch.cat([pad_cols(_as_f32(image(a, r)) if mixed else image(a, r), width) for a, r in pairs])

    preps = [p for _, p in items]
    T = max(p.nat.shape[1] for p in preps)
    T2 = max(p.raw_for_device.shape[1] for p in preps)
    N = max(p.win_nat.shape[1] for p in preps)
    return dict(
        nat=audio([(p.nat, p.nat_dev) for p in preps], T),
        nat_len=torch.cat([put(p.nat_len, torch.int64) for p in preps]),
        win_nat=torch.cat([pad_cols(put(p.win_nat, torch.int64), N) for p in preps]),
        mask=torch.cat([pad_cols(put(p.mask), N) for p in preps]),
        raw=audio([(p.raw_for_device, p.raw_dev) for p in preps], T2),
        raw_len=torch.cat([put(p.raw_len_dev, torch.int64) for p in preps]),
        win_raw=torch.cat([pad_cols(put(p.win_raw_dev, torch.int64), N) for p in preps]),
        T=T,
        T2=T2,
    )


def measure_voices_batched(
    preps: dict[str, PreparedVoice],
    settings: ProsodySettings,
    pitch_params: PitchParams | None = None,
    device="cuda",
) -> dict[str, MeasureResult]:
    """Every voice of a corpus through the device passes, one pass per
    (padded T, sample rate) group: the voices of a group concatenate on the
    segment axis (windows padded to the group's maxima), so kernels A and B
    launch once per group. Every group's work is enqueued before the first
    read back to the host; then one packed buffer per group comes back and
    is sliced by each voice's own segment and window counts. Baselines and
    smoothing stay per voice (``postprocess_voice``), so the results are
    those of per-voice runs.

    Groups are keyed by the padded T because the pitch frame grid is centred
    over the padded buffer, and by the rate because one rate serves a whole
    pass. This is the counterpart of the reference's process pool (one
    pipeline per voice and per OS process). Under the production data mesh
    (``parallel.mesh.production_data_mesh``) each group's rows are split
    over its devices, A and B launching once per group and device."""
    dev = resolve_device(device)
    dsp_precision()
    pp = pitch_params or PitchParams()
    groups: dict[tuple[int, int], list] = {}
    for name, prep in preps.items():
        groups.setdefault((prep.nat.shape[1], int(prep.rate)), []).append((name, prep))

    slots = _slots(dev)
    pending = []
    for (_, rate), items in groups.items():
        with phase("measure/device/to_device"):
            g = _pack_group(items, _pack_dev(slots))
        pending.append((items, _measure_on_slots(g, float(rate), pp, slots), g["nat"].shape[0]))

    results: dict[str, MeasureResult] = {}
    for items, parts, rows in pending:
        with phase("measure/device/wait"):
            out = _unpack6(_read_rows(parts, rows))
        offset = 0
        for name, prep in items:
            S, Nv = prep.nat.shape[0], prep.win_nat.shape[1]
            sl = tuple(o[offset : offset + S, :Nv] if o.ndim == 2 else o[offset : offset + S] for o in out)
            with phase("measure/postprocess"):
                results[name] = postprocess_voice(prep, sl, settings)
            offset += S
    return results

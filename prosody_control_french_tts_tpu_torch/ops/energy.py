"""RMS / dBFS energy scans and pydub-parity silence detection, in PyTorch.

Port of the JAX package's ``ops/energy.py`` (pydub's ``detect_silence`` /
``split_on_silence``, the reference's corpus segmenter). Semantics:

- dBFS is relative to the integer full-scale amplitude
  (``20·log10(rms/32768)`` for int16 sources);
- windows of ``min_silence_len`` ms start at every millisecond, a window is
  silent iff ``floor(rms·32768) <= 10^(thresh/20)·32768``;
- silent windows merge into ranges ``[first_start, last_start + window]``,
  splitting only where a gap exceeds the window length;
- ``split_on_silence_ranges`` pads each nonsilent range by ``keep_silence``
  ms and splits overlapping pads at their midpoint.

The window scan always runs on the device (the JAX package's device path;
the port never loads the native library): the signal is padded to a
power-of-two length, uploaded as its int16 image when that is exact, and
every window's mean square is a bounded-width range sum of one chunked
prefix sum of x² (``ops.cumsum.range_sum_local``).
"""

from __future__ import annotations

import numpy as np
import torch

from .cumsum import chunked_cumsum_sq
from .kernels import resolve_device
from .pcm import f32_to_i16_exact, i16_to_f32


def rms(x, int_scale: float = 32768.0) -> float:
    """pydub/audioop RMS: sqrt(mean(sample²)) on integer-scale samples,
    truncated to an integer. Elementwise float32, the sum in float64."""
    sq = np.square(np.asarray(x, dtype=np.float32) * np.float32(int_scale))
    v = np.sqrt(np.sum(sq, dtype=np.float64) / max(sq.size, 1))
    return float(np.floor(v))


def dbfs(x, int_scale: float = 32768.0) -> float:
    """pydub AudioSegment.dBFS (−inf for digital silence)."""
    r = rms(x, int_scale)
    if r == 0:
        return -np.inf
    return 20.0 * float(np.log10(r / int_scale))


def _window_rms_sq(x: torch.Tensor, rate: int, window_ms: int) -> torch.Tensor:
    """Mean square of every ``window_ms`` window starting at each millisecond
    boundary. x: [T] float32 in [-1, 1), or its int16 image (cast on the
    device). Returns [n_starts] float32."""
    if x.dtype == torch.int16:
        x = i16_to_f32(x)
    T = x.shape[-1]
    cs = chunked_cumsum_sq(x)
    total_ms = int(T * 1000 // rate)
    n_starts = max(total_ms - window_ms + 1, 0)

    def ms_to_samp(ms):
        # exact ⌊ms·rate/1000⌋ in integers: a float32 product loses integer
        # precision past 2²⁴ (~6 min of 44.1 kHz)
        return (ms // 1000) * rate + ((ms % 1000) * rate) // 1000

    starts_ms = torch.arange(n_starts, device=x.device)
    lo = ms_to_samp(starts_ms)
    hi = ms_to_samp(starts_ms + window_ms).clamp(max=T)
    cnt = (hi - lo).clamp(min=1)
    max_span = (window_ms * rate) // 1000 + 1
    return cs.range_sum_local(lo, hi, max_span) / cnt


def detect_silence(
    x,
    rate: int,
    min_silence_len: int = 1000,
    silence_thresh: float = -50.0,
    int_scale: float = 32768.0,
    device="cuda",
) -> list[list[int]]:
    """Silent [start_ms, end_ms] ranges, pydub.silence.detect_silence parity.
    x: float samples in [-1, 1) (numpy); silence_thresh in dBFS."""
    dev = resolve_device(device)
    x = np.asarray(x)
    length_ms = int(len(x) * 1000 // rate)
    if length_ms < min_silence_len:
        return []
    n_starts = max(length_ms - min_silence_len + 1, 0)
    # a power-of-two bucket, as the JAX device path pads: the prefix sums of
    # the original samples are unchanged and every original window ends
    # before the pad, so slicing to the original start count is exact
    T = int(len(x))
    Tp = 1 << max(T - 1, 1).bit_length()
    xp = np.pad(x, (0, Tp - T)) if Tp != T else x
    if xp.dtype == np.float32:
        q = f32_to_i16_exact(xp)
        if q is not None:
            xp = q  # lossless, half the upload
    else:
        xp = xp.astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xp)).to(dev)
    ms2 = _window_rms_sq(xt, rate, min_silence_len).cpu().numpy()[:n_starts]
    # pydub: audioop integer rms <= db_to_float(thresh) * max_amplitude
    win_rms = np.floor(np.sqrt(np.maximum(ms2, 0.0)) * int_scale)
    return _silent_runs(win_rms, silence_thresh, int_scale, min_silence_len)


def _silent_runs(win_rms: np.ndarray, silence_thresh: float, int_scale: float, min_silence_len: int) -> list[list[int]]:
    """Threshold per-ms window RMS and merge into pydub-parity silent ranges."""
    thresh_lin = (10.0 ** (silence_thresh / 20.0)) * int_scale
    silent = win_rms <= thresh_lin
    starts = np.nonzero(silent)[0]
    if starts.size == 0:
        return []
    ranges: list[list[int]] = []
    range_start = int(starts[0])
    prev = int(starts[0])
    for s in starts[1:]:
        s = int(s)
        continuous = s == prev + 1
        has_gap = s > prev + min_silence_len
        if not continuous and has_gap:
            ranges.append([range_start, prev + min_silence_len])
            range_start = s
        prev = s
    ranges.append([range_start, prev + min_silence_len])
    return ranges


def detect_nonsilent(x, rate: int, min_silence_len: int = 1000, silence_thresh: float = -50.0, device="cuda") -> list[list[int]]:
    length_ms = int(len(x) * 1000 // rate)
    silent = detect_silence(x, rate, min_silence_len, silence_thresh, device=device)
    if not silent:
        return [[0, length_ms]]
    if silent == [[0, length_ms]]:
        return []
    out = []
    prev_end = 0
    for s, e in silent:
        if s > prev_end:
            out.append([prev_end, s])
        prev_end = e
    if prev_end < length_ms:
        out.append([prev_end, length_ms])
    if out and out[0] == [0, 0]:
        out.pop(0)
    return out


def split_on_silence_ranges(
    x,
    rate: int,
    min_silence_len: int = 1000,
    silence_thresh: float = -50.0,
    keep_silence: int = 300,
    device="cuda",
) -> list[tuple[int, int]]:
    """[start_ms, end_ms) chunk ranges of pydub.silence.split_on_silence."""
    length_ms = int(len(x) * 1000 // rate)
    nonsilent = detect_nonsilent(x, rate, min_silence_len, silence_thresh, device=device)
    # pydub pads first, splits overlaps at the midpoint, and clamps only
    # when slicing — the order matters for the midpoint arithmetic
    ranges = [[s - keep_silence, e + keep_silence] for s, e in nonsilent]
    for cur, nxt in zip(ranges[:-1], ranges[1:]):
        if nxt[0] < cur[1]:
            mid = (cur[1] + nxt[0]) // 2
            cur[1] = mid
            nxt[0] = mid
    return [(max(s, 0), min(e, length_ms)) for s, e in ranges]

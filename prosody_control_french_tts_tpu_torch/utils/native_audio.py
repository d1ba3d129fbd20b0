"""The port's native audio ingest:
``prosody_control_french_tts_tpu_torch/native/audioio.cpp``, built with
``g++`` at first use and bound with ``ctypes``.

It decodes RIFF/WAVE files, resamples them with a Hann-windowed sinc, loads
a whole corpus into one padded batch (int16 straight from the data chunks
when every file is mono PCM16 at the target rate), writes float32 samples as
PCM16 in one pass and scans windowed RMS. ``prosody.measure._load_padded``
reads corpora through it and ``utils.wavio.write_wav`` writes float32
through it.

The build runs from the source in the checkout into ``build/torch_native/``
at the repository root (``.gitignore`` lists ``build/``); a content hash of
the source and the flags names the library, so an edited source is rebuilt.
A failed build or load raises: there is no Python fallback, whose scipy
resampler would read a mixed-rate corpus otherwise than the windowed sinc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "audioio.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LIB = None
# one build and one load a process, whichever thread calls first
_LIB_LOCK = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_LONGP = ctypes.POINTER(ctypes.c_long)
_SIGNATURES = {
    # path, out, max_out, rate_out
    "audioio_decode": (ctypes.c_char_p, _F32P, ctypes.c_long, ctypes.POINTER(ctypes.c_int)),
    # paths blob, files, target rate, out, stride, lengths
    "audioio_load_batch": (ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _F32P, ctypes.c_long, _LONGP),
    "audioio_load_batch_i16": (ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _I16P, ctypes.c_long, _LONGP),
    # path, samples, count, rate, channels
    "audioio_write_wav_f32": (ctypes.c_char_p, _F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int),
    # x, n, rate, window_ms, out, max_out
    "audioio_window_rms": (_F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_long),
}


def build() -> Path:
    """Compile the library (if this source hash has none yet) and return its
    path. Raises when ``g++`` is missing or fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_DIR / f"libpcft_ingest_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native audio ingest cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{res.stdout.decode(errors='replace')}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded library (built on first use; concurrent first callers wait
    for one build and one load)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()), use_errno=True)
            for fn, args in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = list(args)
                f.restype = ctypes.c_long
            _LIB = lib
    return _LIB


def _blob(paths) -> bytes:
    return b"\0".join(str(p).encode() for p in paths) + b"\0"


def decode(path: str | Path, max_seconds: float = 3600.0):
    """→ (float32 mono samples, rate), or None when the file cannot be read
    or parsed."""
    max_out = int(max_seconds * 192000)
    buf = np.empty(max_out, np.float32)
    rate = ctypes.c_int(0)
    n = library().audioio_decode(str(path).encode(), buf.ctypes.data_as(_F32P), max_out, ctypes.byref(rate))
    if n < 0:
        return None
    return buf[:n].copy(), rate.value


def load_batch(paths: list[str | Path], stride: int, target_rate: int = 0):
    """Decode many files into a padded [S, stride] float32 array, each
    resampled to ``target_rate`` (0: keep the files' rates) → (batch,
    int32 lengths, rate). A file that cannot be read gets length 0 and a
    zero row; the rate is -1 when none could."""
    S = len(paths)
    out = np.zeros((S, stride), np.float32)
    lengths = np.zeros(S, np.int64)
    rate = library().audioio_load_batch(
        _blob(paths), S, target_rate, out.ctypes.data_as(_F32P), stride, lengths.ctypes.data_as(_LONGP)
    )
    return out, np.where(lengths >= 0, lengths, 0).astype(np.int32), int(rate)


def load_batch_i16(paths: list[str | Path], stride: int, target_rate: int = 0):
    """Lossless int16 corpus load: when every file is mono PCM16 at one rate
    (``target_rate``, or the first file's when 0), each data chunk is copied
    into its padded row of a [S, stride] int16 array → (batch, int32
    lengths, rate). None when the corpus needs the float path (a resample,
    a channel mixdown, another format). Unreadable files as ``load_batch``."""
    S = len(paths)
    out = np.zeros((S, stride), np.int16)
    lengths = np.zeros(S, np.int64)
    rate = library().audioio_load_batch_i16(
        _blob(paths), S, target_rate, out.ctypes.data_as(_I16P), stride, lengths.ctypes.data_as(_LONGP)
    )
    if rate < 0:
        return None
    return out, np.where(lengths >= 0, lengths, 0).astype(np.int32), int(rate)


def write_wav_f32(path: str | Path, samples: np.ndarray, rate: int, channels: int) -> bool:
    """Write float32 samples ([N] or interleaved [N, C]) as a PCM16 WAV in
    one pass: ``round(x * 32768)`` half to even and clamped, as
    ``utils.wavio.write_wav``'s numpy path quantizes, and NaN to 0. False
    when the file could not be written (``ctypes.get_errno()`` holds the
    cause)."""
    x = np.ascontiguousarray(samples, np.float32)
    rc = library().audioio_write_wav_f32(str(path).encode(), x.ctypes.data_as(_F32P), x.size, int(rate), int(channels))
    return rc == 0


def window_rms(x: np.ndarray, rate: int, window_ms: int) -> np.ndarray:
    """pydub's windowed RMS at every millisecond start: floor(sqrt(mean(x²))
    · 32768) over windows of ``window_ms``."""
    x = np.ascontiguousarray(x, np.float32)
    total_ms = int(len(x) * 1000 // rate)
    n_starts = max(total_ms - window_ms + 1, 0)
    out = np.empty(max(n_starts, 1), np.float32)
    n = library().audioio_window_rms(x.ctypes.data_as(_F32P), len(x), rate, window_ms, out.ctypes.data_as(_F32P), out.shape[0])
    return out[:n]

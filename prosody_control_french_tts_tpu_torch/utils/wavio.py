"""WAV read/write + resampling, with no third-party audio deps.

The reference leans on pydub/ffmpeg for all decode/encode
(Code/Preprocessing/preprocess_audio.py:39, merge_wav.py) and on pydub's
``AudioSegment`` sample model (int16-centric, ``duration_seconds``,
``get_array_of_samples``). Here audio is decoded straight to numpy float
arrays the device ops consume; pydub semantics that matter numerically
(int16 sample values, dBFS conventions) are preserved by keeping the raw
integer view available.

Pure-stdlib/scipy implementation: ``wave`` handles canonical PCM; a small
RIFF parser covers float32/24-bit/extensible WAVs that ``wave`` rejects.
``write_wav`` writes float32 samples through the native ingest
(``utils.native_audio``), other dtypes through numpy, with the same
quantization; corpora are read through the native ingest by
``prosody.measure``.
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import native_audio


@dataclass
class Audio:
    """A decoded audio buffer.

    samples: float array in [-1, 1), shape [T] (mono) or [T, C]. float32
        for 8/16/24-bit PCM and float32 sources (k·2⁻ⁿ with n ≤ 23 is
        EXACTLY representable in float32, and float64 elementwise math is
        ~150× slower than float32 on this host's vCPU); float64 only for
        int32/float64 sources, whose mantissas don't fit.
    rate: sample rate in Hz.
    source_dtype: numpy dtype string of the on-disk samples ("int16", ...).
    """

    samples: np.ndarray
    rate: int
    source_dtype: str = "int16"

    @property
    def duration_seconds(self) -> float:
        return self.samples.shape[0] / float(self.rate)

    @property
    def num_channels(self) -> int:
        return 1 if self.samples.ndim == 1 else self.samples.shape[1]

    def to_mono(self) -> "Audio":
        if self.samples.ndim == 1:
            return self
        return Audio(self.samples.mean(axis=1), self.rate, self.source_dtype)

    def int_samples(self) -> np.ndarray:
        """Raw integer-scale samples (pydub ``get_array_of_samples`` view).

        The reference feeds pyloudnorm with raw int16-valued floats divided
        by their peak (Code/audioPipeline.py:343-350); exposing the integer
        scale keeps that normalisation bit-compatible.
        """
        if self.source_dtype == "float32":
            return self.samples * 32768.0
        info = np.iinfo(self.source_dtype)
        return self.samples * float(max(abs(info.min), info.max))

    def slice_ms(self, t0_ms: float | None = None, t1_ms: float | None = None) -> "Audio":
        """Slice by milliseconds, matching pydub AudioSegment[a:b] indexing
        (millisecond granularity: sample index = ms * rate // 1000)."""
        n = self.samples.shape[0]
        i0 = 0 if t0_ms is None else int(t0_ms * self.rate // 1000)
        i1 = n if t1_ms is None else int(t1_ms * self.rate // 1000)
        i0 = max(0, min(n, i0))
        i1 = max(i0, min(n, i1))
        return Audio(self.samples[i0:i1], self.rate, self.source_dtype)


_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path) -> Audio:
    """Decode a RIFF/WAVE file to float samples in [-1, 1) (float32 where
    exact — see Audio docstring)."""
    raw = Path(path).read_bytes()
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid, size = raw[pos : pos + 4], struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (tag, channels, rate, _brate, _balign, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        tag = struct.unpack("<H", fmt[24:26])[0]

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        arr = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8")
        arr = arr if bits == 32 else arr.astype(np.float64)
        src = "float32"
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            # k/32768 with |k| ≤ 32768 is exact in float32
            arr = np.frombuffer(data, dtype="<i2").astype(np.float32) * np.float32(1.0 / 32768.0)
            src = "int16"
        elif bits == 8:
            arr = (np.frombuffer(data, dtype="u1").astype(np.float32) - np.float32(128.0)) * np.float32(1.0 / 128.0)
            src = "int8"
        elif bits == 32:
            # 32-bit mantissas don't fit float32 — keep float64 here
            arr = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2147483648.0
            src = "int32"
        elif bits == 24:
            b = np.frombuffer(data, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            # k·2⁻²³ with |k| ≤ 2²³ is exact in float32
            arr = vals.astype(np.float32) * np.float32(1.0 / (1 << 23))
            src = "int32"
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format tag {tag}")

    if channels > 1:
        arr = arr[: (len(arr) // channels) * channels].reshape(-1, channels)
    return Audio(arr, rate, src)


def wav_info(path: str | Path) -> tuple[int, int]:
    """(mono_sample_count, rate) from the RIFF headers only — no sample
    decode (used to size batch buffers before the native loader runs)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        channels, rate, bits, data_len = 1, 0, 16, 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(size + (size & 1))
                _tag, channels, rate, _br, _ba, bits = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                data_len = size
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)
        if not rate:
            raise ValueError(f"{path}: missing fmt chunk")
        bytes_per = max(bits // 8, 1) * max(channels, 1)
        return data_len // bytes_per, rate


def write_wav(path: str | Path, audio: Audio | np.ndarray, rate: int | None = None) -> None:
    """Write PCM16 WAV (the reference's universal interchange format)."""
    if isinstance(audio, Audio):
        samples, rate = audio.samples, audio.rate
    else:
        samples = audio
        if rate is None:
            raise ValueError("rate required when writing a bare array")
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    else:
        channels = samples.shape[1]
    if samples.dtype == np.float32:
        # one pass in the native ingest (the same quantization; the numpy
        # path below makes ~5 passes and 2 whole-buffer copies)
        if not native_audio.write_wav_f32(path, samples, int(rate), channels):
            err = ctypes.get_errno()
            raise OSError(err, os.strerror(err), str(path))
        return
    pcm = np.clip(np.round(samples * 32768.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, _WAVE_FORMAT_PCM, channels, int(rate), int(rate) * channels * 2, channels * 2, 16
    )
    hdr += b"data" + struct.pack("<I", len(data))
    Path(path).write_bytes(hdr + data)


def silence(duration_ms: float, rate: int) -> Audio:
    """pydub ``AudioSegment.silent`` equivalent (Code/audioPipeline.py:819)."""
    n = int(round(duration_ms * rate / 1000.0))
    # float32: concatenating float64 silence into a float32 stream would
    # promote the WHOLE stitched signal to (pathologically slow) float64
    return Audio(np.zeros(n, dtype=np.float32), rate)


def resample(audio: Audio, new_rate: int) -> Audio:
    """Polyphase resampling (host-side; used only at ingest)."""
    if audio.rate == new_rate:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(audio.rate), int(new_rate))
    up, down = new_rate // g, audio.rate // g
    out = resample_poly(audio.samples, up, down, axis=0)
    return Audio(out, new_rate, audio.source_dtype)


def fade(samples: np.ndarray, rate: int, fade_in_ms: float = 0.0, fade_out_ms: float = 0.0) -> np.ndarray:
    """Linear-amplitude fade in/out.

    pydub's ``fade_in``/``fade_out`` (Code/audioPipeline.py:803) ramp gain
    linearly in dB from -120 dB; a linear amplitude ramp over the same 5 ms
    serves the identical purpose (click suppression at stitch points).
    """
    # dtype-preserving: float32 streams stay float32 (float64 host math is
    # ~150× slower on this vCPU); integer input still widens to float
    out = samples.astype(samples.dtype if samples.dtype.kind == "f" else np.float64, copy=True)
    n = out.shape[0]
    ni = min(n, int(fade_in_ms * rate / 1000.0))
    no = min(n, int(fade_out_ms * rate / 1000.0))
    if ni > 0:
        out[:ni] *= np.linspace(0.0, 1.0, ni, endpoint=False)
    if no > 0:
        out[n - no :] *= np.linspace(0.0, 1.0, no, endpoint=False)[::-1]
    return out

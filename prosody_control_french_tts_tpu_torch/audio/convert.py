"""MP3 (and other compressed formats) ingest (host only; a copy of the JAX
package's ``audio/convert.py``).

The reference shells out to pydub/ffmpeg (Code/Preprocessing/
convert_mp3_to_wav.py:6): copy wavs through, convert mp3s. Wav is decoded
natively; compressed formats go to an external ``ffmpeg`` binary when one is
on the PATH and fail with a clear message otherwise (nothing in the numeric
pipeline depends on mp3 support).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path

log = logging.getLogger(__name__)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def convert_to_wav(src: str | Path, dst: str | Path, rate: int | None = None) -> Path:
    """wav → copy; mp3/m4a/ogg → ffmpeg decode (mono, optional rate)."""
    src, dst = Path(src), Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    if src.suffix.lower() == ".wav":
        if src.resolve() != dst.resolve():
            shutil.copy(src, dst)
        return dst
    if not ffmpeg_available():
        raise RuntimeError(
            f"cannot decode {src.suffix} without ffmpeg; install ffmpeg or "
            "provide wav input (the reference had the same dependency via pydub)"
        )
    cmd = ["ffmpeg", "-y", "-i", str(src), "-ac", "1"]
    if rate:
        cmd += ["-ar", str(rate)]
    cmd.append(str(dst))
    subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
    return dst


def convert_folder(in_dir: str | Path, out_dir: str | Path) -> int:
    """convert_mp3_to_wav.main semantics: every audio file in in_dir lands
    as a wav in out_dir."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    n = 0
    for f in sorted(in_dir.iterdir()):
        if f.suffix.lower() in (".wav", ".mp3", ".m4a", ".ogg", ".flac"):
            convert_to_wav(f, out_dir / (f.stem + ".wav"))
            n += 1
    return n

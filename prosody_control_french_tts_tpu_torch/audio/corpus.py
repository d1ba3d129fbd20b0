"""Corpus assembly helpers (host only; a copy of the JAX package's
``audio/corpus.py``).

- ``build_natural_corpus``: collect every voice's segment wav + transcript
  pair into one flat corpus directory
  (Code/Preprocessing/create_natural_data.py semantics), the corpus
  ``align.train_ctc`` trains on.
- ``stage_abtest_files``: copy each voice's improved OUT.wav and its merged
  raw synthesis into A/B-test staging directories
  (Code/Preprocessing/combine_files_for_abtest.py).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

from .merge import merge_wav_from_folder

log = logging.getLogger(__name__)


def build_natural_corpus(data_dir: str | Path, out_dir: str | Path) -> int:
    """Copy segment_ph*.wav + matching .txt from each voice folder into
    out_dir as <voice>__segment_phN.{wav,txt}. Returns pair count."""
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for voice_dir in sorted(p for p in data_dir.iterdir() if p.is_dir()):
        if voice_dir.name.endswith(("_raw", "_ssml")):
            continue
        audio = voice_dir / "audio"
        txts = voice_dir / "transcription"
        if not audio.is_dir():
            continue
        for wav in sorted(audio.glob("segment_ph*.wav")):
            txt = txts / f"{wav.stem}.txt"
            if not txt.exists():
                continue
            stem = f"{voice_dir.name}__{wav.stem}"
            shutil.copy(wav, out_dir / f"{stem}.wav")
            shutil.copy(txt, out_dir / f"{stem}.txt")
            n += 1
    log.info("natural corpus: %d pairs in %s", n, out_dir)
    return n


def stage_abtest_files(results_dir: str | Path, data_dir: str | Path, out_dir: str | Path) -> int:
    """For each voice with results, copy the improved OUT.wav and the
    merged raw synthesis into out_dir/{improved,raw}/<voice>.wav. Returns
    the count of voices whose raw synthesis was merged."""
    results_dir, data_dir, out_dir = Path(results_dir), Path(data_dir), Path(out_dir)
    improved_dir = out_dir / "improved"
    raw_dir = out_dir / "raw"
    improved_dir.mkdir(parents=True, exist_ok=True)
    raw_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for voice in sorted(p for p in results_dir.iterdir() if p.is_dir()):
        out_wav = voice / "OUT.wav"
        if not out_wav.exists():
            continue
        shutil.copy(out_wav, improved_dir / f"{voice.name}.wav")
        raw_audio = data_dir / f"{voice.name}_raw" / "audio"
        if raw_audio.is_dir() and merge_wav_from_folder(raw_audio, raw_dir / f"{voice.name}.wav"):
            n += 1
    return n

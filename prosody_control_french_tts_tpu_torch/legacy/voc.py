"""Legacy ``Voc`` orchestrator: the 14-step BDD chain with checkpoint-file
resume (Code/pipeline_class_legacy.py:68-971).

Steps map onto the rebuilt stages:

  align → extract rows → NW align → add breaks (BDD1) → pitch (BDD2) →
  loudness (BDD3) → rate (BDD4) → SSML fragments (BDD5) → per-segment TTS
  → merge OUT.wav

State is on disk (CSV per stage) exactly like the reference, and each
stage touches ``checkpoint_<step>_done.txt`` and is skipped on resume when
``check_checkfiles=True`` (pipeline_class_legacy.py:545-562).
"""

from __future__ import annotations

import csv
import logging
from dataclasses import asdict
from pathlib import Path

from ..ops.kernels import resolve_device
from ..tts.base import TTSBackend
from ..utils.textgridio import read_textgrid
from ..utils.wavio import write_wav
from .bdd import (
    LegacySyntagme,
    add_breaks,
    align_rows,
    build_ssml_fragments,
    compute_loudness_adjustments,
    compute_pitch_adjustments,
    compute_rate_adjustments,
    construct_syntagmes,
    extract_segment_rows,
)

log = logging.getLogger(__name__)


class Voc:
    def __init__(
        self,
        voice_dir: str | Path,
        synth_dir: str | Path,
        out_dir: str | Path,
        tts: TTSBackend,
        voice_name: str = "fr-FR-HenriNeural",
        check_checkfiles: bool = True,
        device="cuda",
    ):
        """The pitch stage (BDD2) runs on ``device``, CUDA by default (a
        CPU run is asked for with ``device="cpu"``)."""
        self.device = resolve_device(device)
        self.voice_dir = Path(voice_dir)
        self.synth_dir = Path(synth_dir)
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.tts = tts
        self.voice_name = voice_name
        self.check_checkfiles = check_checkfiles
        self.synts: list[LegacySyntagme] = []

    # -- checkpoint contract (pipeline_class_legacy.py:545-562) ----------
    def _ckpt(self, step: str) -> Path:
        return self.out_dir / f"checkpoint_{step}_done.txt"

    def _done(self, step: str) -> bool:
        return self.check_checkfiles and self._ckpt(step).exists()

    def _mark(self, step: str) -> None:
        self._ckpt(step).write_text("done", encoding="utf-8")

    # -- stages -----------------------------------------------------------
    def extract_and_align(self) -> list:
        step = "align"
        rows_all = []
        nat_tg_dir = self.voice_dir / "WhisperTS_textgrid_files"
        syn_tg_dir = self.synth_dir / "WhisperTS_textgrid_files"
        for nat_tg in sorted(nat_tg_dir.glob("*.TextGrid")):
            syn_tg = syn_tg_dir / nat_tg.name
            if not syn_tg.exists():
                log.warning("no synthetic TextGrid for %s", nat_tg.name)
                continue
            stem = nat_tg.stem
            nat_rows = extract_segment_rows(
                read_textgrid(nat_tg), stem, str(self.voice_dir / "audio" / f"{stem}.wav")
            )
            syn_rows = extract_segment_rows(
                read_textgrid(syn_tg), stem, str(self.synth_dir / "audio" / f"{stem}.wav")
            )
            rows_all.extend(align_rows(nat_rows, syn_rows))
        self._mark(step)
        return rows_all

    def run_chain(self) -> list[dict]:
        rows = self.extract_and_align()
        rows = add_breaks(rows)  # BDD1
        self.synts = construct_syntagmes(rows)
        compute_pitch_adjustments(self.synts, device=self.device)  # BDD2
        self._dump_csv("BDD2.csv")
        compute_loudness_adjustments(self.synts)  # BDD3
        self._dump_csv("BDD3.csv")
        compute_rate_adjustments(self.synts)  # BDD4
        self._dump_csv("BDD4.csv")
        bdd5 = build_ssml_fragments(self.synts, self.voice_name)
        with open(self.out_dir / "BDD_ssml.csv", "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=["segment", "syntagme", "ssml"])
            w.writeheader()
            w.writerows(bdd5)
        return bdd5

    def _dump_csv(self, name: str) -> None:
        if not self.synts:
            return
        with open(self.out_dir / name, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(asdict(self.synts[0]).keys()))
            w.writeheader()
            for s in self.synts:
                w.writerow(asdict(s))

    def synthesize_and_merge(self, bdd5: list[dict]) -> Path:
        """TTS per BDD5 row + numeric-order merge
        (Code/Pipeline/TTS_df.py:12-108)."""
        import numpy as np

        from ..audio.merge import merge_wavs
        from ..utils.wavio import Audio

        seg_dir = self.out_dir / "segments"
        seg_dir.mkdir(exist_ok=True)
        paths = []
        for row in sorted(bdd5, key=lambda r: int(r["segment"])):
            try:
                audio = self.tts.synthesize(row["ssml"])
            except Exception as e:  # noqa: BLE001 — degraded row
                log.warning("TTS failed for segment %s: %s", row["segment"], e)
                audio = Audio(np.zeros(0), getattr(self.tts, "sample_rate", 44100))
            p = seg_dir / f"segment_ph{row['segment']}.wav"
            write_wav(p, audio)
            paths.append(p)
        merged = merge_wavs(paths)
        out = self.out_dir / "OUT.wav"
        if merged is not None:
            write_wav(out, merged)
        self._mark("tts_merge")
        return out

    def run_pipeline(self) -> Path:
        if self._done("tts_merge"):
            log.info("legacy chain already complete (checkpoint)")
            return self.out_dir / "OUT.wav"
        bdd5 = self.run_chain()
        return self.synthesize_and_merge(bdd5)

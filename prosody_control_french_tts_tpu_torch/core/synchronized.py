"""Synchronized-SSML pipeline: the reference's standalone 6-step flow
(Code/Pipeline/synchronized_ssml.py:32-820). Host only (TTS backend, wav and
TextGrid files); a copy of the JAX package's ``core/synchronized.py``.

1. V1: break-only SSML per segment from TextGrid + corrected transcript
   (word alignment, pauses ≥150 ms);
2. calibration synthesis of V1;
3. duration analysis: rate adjustment = (nat_ms/syn_ms − 1)·100 clamped
   to [−50, +100] (:548-552);
4. V2: same sequences wrapped in a global <prosody rate=...>;
5. final synthesis of V2;
6. numeric-order concatenation to one output wav.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from pathlib import Path

from ..audio.merge import merge_wavs
from ..ssml.emit import break_only_ssml
from ..ssml.syntagme import align_natural_to_transcript, extract_words_and_pauses
from ..tts.base import TTSBackend
from ..utils.wavio import read_wav, write_wav

log = logging.getLogger(__name__)


@dataclass
class SynchronizedSSMLPipeline:
    audio_dir: Path
    textgrid_dir: Path
    transcription_dir: Path
    work_dir: Path
    tts: TTSBackend
    voice: str = "fr-FR-HenriNeural"
    adjustments: dict[str, dict] = field(default_factory=dict)

    def __post_init__(self):
        self.audio_dir = Path(self.audio_dir)
        self.textgrid_dir = Path(self.textgrid_dir)
        self.transcription_dir = Path(self.transcription_dir)
        self.work_dir = Path(self.work_dir)
        (self.work_dir / "ssml").mkdir(parents=True, exist_ok=True)
        (self.work_dir / "audio").mkdir(parents=True, exist_ok=True)

    # step 1 --------------------------------------------------------------
    def build_v1(self) -> list[Path]:
        out = []
        for tg_path in sorted(self.textgrid_dir.glob("*.TextGrid")):
            stem = tg_path.stem
            txt = self.transcription_dir / f"{stem}.txt"
            if not txt.exists():
                log.warning("no transcript for %s", stem)
                continue
            text = txt.read_text(encoding="utf-8").strip().replace("...", ".")
            seq = extract_words_and_pauses(str(tg_path))
            aligned = align_natural_to_transcript(seq, text.split())
            ssml = break_only_ssml(aligned, self.voice)
            p = self.work_dir / "ssml" / f"SSML_V1_{stem}.xml"
            p.write_text(ssml, encoding="utf-8")
            out.append(p)
        return out

    # step 2 / 5 ----------------------------------------------------------
    def _synthesize(self, ssml_files: list[Path], prefix: str) -> list[Path]:
        out = []
        for p in ssml_files:
            stem = p.stem.replace("SSML_V1_", "").replace("SSML_V2_", "")
            try:
                audio = self.tts.synthesize(p.read_text(encoding="utf-8"))
            except Exception as e:  # noqa: BLE001
                log.warning("synthesis failed for %s: %s", stem, e)
                continue
            wav = self.work_dir / "audio" / f"{prefix}_{stem}.wav"
            write_wav(wav, audio)
            out.append(wav)
        return out

    def synthesize_calibration(self, ssml_files: list[Path]) -> list[Path]:
        return self._synthesize(ssml_files, "TTS_V1")

    # step 3 --------------------------------------------------------------
    def analyze_durations(self, calibration_files: list[Path]) -> dict[str, dict]:
        adjustments = {}
        for wav in calibration_files:
            stem = wav.stem.replace("TTS_V1_", "")
            nat = self.audio_dir / f"{stem}.wav"
            if not nat.exists():
                continue
            syn_ms = read_wav(wav).duration_seconds * 1000.0
            nat_ms = read_wav(nat).duration_seconds * 1000.0
            if syn_ms <= 0:
                continue
            rate_adjustment = max(-50.0, min(100.0, (nat_ms / syn_ms - 1.0) * 100.0))
            adjustments[stem] = {
                "rate_adjustment": rate_adjustment,
                "natural_duration": nat_ms,
                "synthetic_duration": syn_ms,
            }
        self.adjustments = adjustments
        return adjustments

    # step 4 --------------------------------------------------------------
    def build_v2(self, adjustments: dict[str, dict]) -> list[Path]:
        out = []
        for stem, vals in adjustments.items():
            v1 = self.work_dir / "ssml" / f"SSML_V1_{stem}.xml"
            if not v1.exists():
                continue
            content = v1.read_text(encoding="utf-8")
            # wrap the voice body in a global prosody rate
            rate = vals["rate_adjustment"]
            body = re.search(r"<voice[^>]*>(.*)</voice>", content, re.DOTALL)
            if not body:
                continue
            inner = body.group(1)
            wrapped = f'<prosody rate="{rate:+.2f}%">{inner}</prosody>'
            v2_content = content[: body.start(1)] + wrapped + content[body.end(1) :]
            p = self.work_dir / "ssml" / f"SSML_V2_{stem}.xml"
            p.write_text(v2_content, encoding="utf-8")
            out.append(p)
        return out

    def synthesize_final(self, ssml_files: list[Path]) -> list[Path]:
        return self._synthesize(ssml_files, "TTS_V2")

    # step 6 --------------------------------------------------------------
    def concatenate(self, audio_files: list[Path], output: Path | None = None) -> Path | None:
        output = output or (self.work_dir / "OUT_synchronized.wav")
        merged = merge_wavs(sorted(audio_files, key=lambda p: p.name))
        if merged is None:
            return None
        write_wav(output, merged)
        return output

    def run_pipeline(self) -> Path | None:
        v1 = self.build_v1()
        cal = self.synthesize_calibration(v1)
        adj = self.analyze_durations(cal)
        v2 = self.build_v2(adj)
        final = self.synthesize_final(v2)
        return self.concatenate(final)

"""The per-voice pipeline in PyTorch: the reference's eight-step state
machine.

Port of the JAX package's ``core/pipeline.py``. Step names, directory
conventions and artifacts are the same, so voice layouts and
``steps_to_run`` configs run unchanged:

    Data/voice/<name>/{brute,audio,transcription,transcription_raw,
                       WhisperTS_textgrid_files}
    Data/voice/<name>_raw/{audio,transcription}
    Data/voice/<name>_ssml/{xml_files,audio}
    Out/results/<name>/{BDD_ssml.csv,BDD_syntagme_ssml.csv,
                        BDD_syntagme_for_synth.csv,OUT.wav,...}

The steps: 1 Preprocess (the spectral gate or the MaskNet separator on the
device, or a ``denoise_command`` on the host, or identity; then the silence
split, ``ops.energy``, on the device); 2 Align+Transcribe (the ``whisper``
or ``ctc`` acoustic aligner, or the ``energy`` aligner, on the device, or
``precomputed`` TextGrids); 3 Raw Synthesis; 4 Measure & Build SSML
(``prosody.measure`` on the device, kernels A and B, then the three BDD
CSVs); 5 Synthesize+Merge; 6 Export JSON; 7 Final Transcribe (the
configured acoustic aligner over OUT.wav, or the energy aligner); 8
Compare Breaks. ``AudioPipeline(name, cfg, device="cuda").run()`` is the
entry point; the device reaches the denoisers, the silence scan, every
aligner call and the measure step. ``main()`` runs every voice of a
config, with ``multiprocessing: true`` through ``core.batch_runner`` (one
batched measure pass for all voices).

The TTS backend is ``tts_backend``'s (``azure``: the Azure REST client,
``tts.azure``; ``fake``: the deterministic fake) unless a backend object is
passed in. The POS backend is ``pos_backend``'s (the lexicon, or the
contextual tagger on the pipeline's device). The corpus prefetch
(``prosody.measure.prefetch_corpus`` / ``prefetch_segment``) loads and
uploads the natural corpus after the silence split and again at the start
of Align (a no-op when its files are unchanged), each raw segment as Raw
Synthesis writes it, and the raw corpus after it, so that the measure step
finds both corpora loaded and on the device.
``measure_and_build_ssml`` runs step 4 alone.
"""

from __future__ import annotations

import csv
import logging
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from ..align.base import get_aligner
from ..align.energy import EnergyAligner
from ..audio.denoise import denoise as spectral_denoise
from ..audio.separate import MaskSeparator
from ..eval.breaks import compare_breaks
from ..models.pos_tagger import get_pos_backend
from ..ops.energy import split_on_silence_ranges
from ..ops.kernels import resolve_device
from ..prosody.adjust import ProsodySettings
from ..prosody.measure import MeasureResult, measure_voice, prefetch_corpus, prefetch_segment, segment_sort_key
from ..ssml import emit as ssml_emit
from ..ssml.parse import combine_training_data, write_training_json
from ..tts.base import TTSBackend
from ..tts.stitch import stitch_rows
from ..utils import fr_pos, yaml_emit
from ..utils.text import clean_transcript
from ..utils.textgridio import read_textgrid, write_textgrid
from ..utils.wavio import Audio, read_wav, wav_info, write_wav
from .config import PipelineConfig
from .profiling import StepTimer, phase

log = logging.getLogger(__name__)

CSV_NAMES = ("BDD_ssml.csv", "BDD_syntagme_ssml.csv", "BDD_syntagme_for_synth.csv")
_HAS_WORD = re.compile(r"\w")


def emit_measure_csvs(result: MeasureResult, results_dir: Path, voice: str, factor: float) -> list[Path]:
    """Render a MeasureResult into the three BDD CSVs under results_dir."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    seg_csv, syn_csv, synth_csv = (results_dir / n for n in CSV_NAMES)

    def piece(row, include_break=True):
        return ssml_emit.prosody_piece(
            row.syntagme, row.pause, row.pitch_smooth, row.rate_smooth, row.raw_volume, factor,
            include_break=include_break,
        )

    # segment level (Code/audioPipeline.py:604-647)
    pieces_by_seg: dict[str, list[str]] = {}
    for row in result.rows:
        pieces_by_seg.setdefault(row.segment, []).append(piece(row))
    with open(seg_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["segment", "ssml"])
        w.writeheader()
        for seg, pieces in pieces_by_seg.items():
            w.writerow({"segment": seg, "ssml": ssml_emit.segment_ssml(pieces, voice)})

    # syntagme-level training CSV (Code/audioPipeline.py:649-682) and the
    # no-break synthesis CSV (Code/audioPipeline.py:684-711)
    for path, include_break, wrap in (
        (syn_csv, True, ssml_emit.syntagme_ssml),
        (synth_csv, False, ssml_emit.syntagme_ssml_no_break),
    ):
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=["segment", "syntagme", "pause", "ssml"])
            w.writeheader()
            for row in result.rows:
                w.writerow(
                    {
                        "segment": row.segment,
                        "syntagme": row.syntagme,
                        "pause": row.pause,
                        "ssml": wrap(piece(row, include_break), voice),
                    }
                )
    return [seg_csv, syn_csv, synth_csv]


def setup_logging(out_dir: Path) -> logging.Logger:
    """Console WARNING+, Out/logs/pipeline_debug.log DEBUG+."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(logging.DEBUG)
    logs = Path(out_dir) / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    ch = logging.StreamHandler()
    ch.setLevel(logging.WARNING)
    ch.setFormatter(fmt)
    root.addHandler(ch)
    fh = logging.FileHandler(str(logs / "pipeline_debug.log"), mode="w", encoding="utf-8")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    root.addHandler(fh)
    return root


def _read_rows(path: Path) -> list[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


class AudioPipeline:
    STEP_NAMES = [
        "Preprocess",
        "Align+Transcribe",
        "Raw Synthesis",
        "Measure & Build SSML",
        "Synthesize+Merge",
        "Export JSON",
        "Final Transcribe",
        "Compare Breaks",
    ]

    def __init__(self, name: str, cfg: PipelineConfig, tts: TTSBackend | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        # written by run() after the steps; a config the emitter cannot write
        # is refused here, before any step runs
        self.config_yaml = yaml_emit.dump(cfg.raw)

        self.data_dir = cfg.data_path
        self.out_dir = cfg.out_path
        self.voice_dir = self.data_dir / name
        self.raw_synth_dir = self.data_dir / f"{name}_raw"
        self.ssml_dir = self.data_dir / f"{name}_ssml"
        self.xml_dir = self.ssml_dir / "xml_files"
        self.audio_out = self.ssml_dir / "audio"
        self.results_dir = self.out_dir / "results" / name
        self.audio_ssml_dir = self.results_dir / "segmented_audio"

        self.textgrid_dir = self.voice_dir / "WhisperTS_textgrid_files"
        self.transcription_dir = self.voice_dir / "transcription"
        self.transcription_raw_dir = self.voice_dir / "transcription_raw"
        self.raw_audio_dir = self.raw_synth_dir / "audio"
        self.bdd_ssml_csv, self.bdd_syntagme_ssml_csv, self.bdd_syntagme_synth_csv = (
            self.results_dir / n for n in CSV_NAMES
        )

        self.tts = tts or self._make_tts()
        for d in (self.raw_synth_dir, self.ssml_dir, self.xml_dir, self.audio_out, self.audio_ssml_dir, self.results_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.last_measure: MeasureResult | None = None
        self.last_split: list[tuple[int, int]] | None = None
        self.last_breaks = None
        self.pos_backend = get_pos_backend(cfg.pos_backend, device=self.device)

    def _make_tts(self) -> TTSBackend:
        """``tts_backend: fake`` → the fake; anything else → the Azure REST
        client (no network call until the first synthesis)."""
        if self.cfg.tts_backend == "fake":
            from ..tts.fake import FakeBackend

            return FakeBackend()
        from ..tts.azure import AzureBackend

        return AzureBackend(api_key=self.cfg.read_azure_key(), region=self.cfg.azure_region, voice=self.cfg.azure_voice_name)

    def _segment_files(self) -> list[Path]:
        return sorted((self.voice_dir / "audio").glob("*.wav"), key=segment_sort_key)

    # 1 ------------------------------------------------------------------
    def preprocess(self):
        """Denoise + silence split. ``denoise: spectral`` (the quantile
        spectral gate, ``audio.denoise``) and ``denoise: mask`` (the MaskNet
        separator, ``audio.separate``; ``denoise_options`` go to
        ``MaskSeparator``) run on the pipeline's device, and a failure of
        either raises: unlike the JAX package, the original is not copied in
        their place. Otherwise ``denoise_command`` (a subprocess on the host,
        given {input} and {output} wav paths) runs, and on its failure the
        original is copied, as the reference's Demucs step does; without it
        the denoiser is identity (a hard link)."""
        log.info(">>> Preprocess: denoise + silence-split")
        brute = None
        for cand in ("segment.wav", "segment_demucs.wav", "segment.mp3"):
            p = self.voice_dir / "brute" / cand
            if p.exists():
                brute = p
                break
        if brute is None:
            raise FileNotFoundError("No brute audio found for preprocessing")
        if brute.suffix == ".mp3":
            raise ValueError("mp3 ingest requires ffmpeg; convert to wav first")

        denoised = self.voice_dir / "brute" / "segment_denoised.wav"
        # a previous identity run may have left `denoised` hard-linked to the
        # original: writing through it would truncate the raw recording, so
        # every branch starts from a clean slate
        denoised.unlink(missing_ok=True)
        cmd = self.cfg.raw.get("denoise_command")
        denoiser = self.cfg.raw.get("denoise")
        if denoiser == "spectral":
            with phase("preprocess/denoise"):
                write_wav(denoised, spectral_denoise(read_wav(brute), device=self.device))
        elif denoiser == "mask":
            with phase("preprocess/denoise"):
                sep = MaskSeparator(**self.cfg.raw.get("denoise_options", {}), device=self.device)
                write_wav(denoised, sep.separate(read_wav(brute)))
        elif cmd:
            try:
                subprocess.run(
                    [c.format(input=str(brute), output=str(denoised)) for c in cmd], check=True, timeout=3600
                )
            except Exception as e:  # noqa: BLE001 — the reference's denoiser contract
                log.warning("denoise command failed (%s); copying original", e)
                shutil.copy(brute, denoised)
        else:
            try:
                os.link(brute, denoised)
            except OSError:
                shutil.copy(brute, denoised)

        with phase("preprocess/read"):
            audio = read_wav(denoised).to_mono()
        with phase("preprocess/vad"):
            ranges = split_on_silence_ranges(
                np.asarray(audio.samples, np.float32),
                audio.rate,
                self.cfg.silence.min_silence_len,
                self.cfg.silence.silence_thresh,
                self.cfg.silence.keep_silence,
                device=self.device,
            )
        self.last_split = ranges
        out_dir = self.voice_dir / "audio"
        out_dir.mkdir(parents=True, exist_ok=True)
        with phase("preprocess/write_segments"):
            for i, (s, e) in enumerate(ranges):
                write_wav(out_dir / f"segment_ph{i + 1}.wav", audio.slice_ms(s, e))
        log.info("silence split: %d segments", len(ranges))
        # the natural corpus is final: load and upload it while the next
        # steps work
        with phase("preprocess/prefetch"):
            prefetch_corpus(self._segment_files(), device=self.device)

    # 2 ------------------------------------------------------------------
    def _aligner(self):
        """The configured aligner (``aligner_options`` passed on) on the
        pipeline's device."""
        return get_aligner(self.cfg.aligner, **{**self.cfg.raw.get("aligner_options", {}), "device": self.device})

    def align_and_transcribe(self):
        """Aligner → TextGrids + transcripts. With aligner=precomputed the
        existing TextGrids are used as they are; the other aligners
        regenerate them (the energy and CTC aligners from the raw
        transcripts, Whisper with or without them). Raw transcripts keep
        punctuation; the cleaned ones get the spurious-comma filter."""
        log.info(">>> Align & Transcribe (%s)", self.cfg.aligner)
        tg_dir = self.textgrid_dir
        txt_dir = self.transcription_dir
        txt_raw_dir = self.transcription_raw_dir
        for d in (txt_dir, txt_raw_dir):
            d.mkdir(parents=True, exist_ok=True)

        seg_files = self._segment_files()
        if not seg_files:
            raise FileNotFoundError(f"no segments in {self.voice_dir / 'audio'}")
        prefetch_corpus(seg_files, device=self.device)
        precomputed = self.cfg.aligner == "precomputed"
        if not precomputed:
            shutil.rmtree(tg_dir, ignore_errors=True)
        tg_dir.mkdir(parents=True, exist_ok=True)
        aligner = get_aligner("precomputed", textgrid_dir=tg_dir) if precomputed else self._aligner()

        # a corpus-batched aligner (WhisperAligner.align_batch) takes the
        # segments in groups of up to ~6 min of 44.1 kHz audio (16 M
        # samples), a few device passes a group instead of a set per segment
        batch_tgs: dict[str, object] = {}
        if not precomputed and hasattr(aligner, "align_batch"):
            cap = 16_000_000  # samples per group
            group: list[tuple[str, Audio, str | None]] = []

            def flush():
                if group:
                    tgs = aligner.align_batch([g[1] for g in group], [g[2] for g in group])
                    batch_tgs.update(zip((g[0] for g in group), tgs))
                    group.clear()

            for wav_path in seg_files:
                t_raw = txt_raw_dir / f"{wav_path.stem}.txt"
                tr = t_raw.read_text(encoding="utf-8").strip() if t_raw.exists() else None
                group.append((wav_path.stem, read_wav(wav_path).to_mono(), tr))
                if sum(g[1].samples.size for g in group) >= cap:
                    flush()
            flush()

        for wav_path in seg_files:
            stem = wav_path.stem
            tg_path = tg_dir / f"{stem}.TextGrid"
            if precomputed:
                if not tg_path.exists():
                    raise FileNotFoundError(f"aligner=precomputed but {tg_path} missing; run a real aligner")
                tg = aligner.for_segment(stem).align(None)
            elif stem in batch_tgs:
                tg = batch_tgs[stem]
                write_textgrid(tg, tg_path)
            else:
                audio = read_wav(wav_path).to_mono()
                t_raw = txt_raw_dir / f"{stem}.txt"
                transcript = t_raw.read_text(encoding="utf-8").strip() if t_raw.exists() else None
                tg = aligner.align(audio, transcript)
                write_textgrid(tg, tg_path)

            words = " ".join(iv.mark.strip() for iv in tg.tiers[0] if iv.mark.strip())
            raw_txt = txt_raw_dir / f"{stem}.txt"
            if not raw_txt.exists():
                raw_txt.write_text(words or "...", encoding="utf-8")
            cleaned = self.pos_backend.remove_spurious_commas(clean_transcript(words))
            (txt_dir / f"{stem}.txt").write_text(cleaned, encoding="utf-8")

    # 3 ------------------------------------------------------------------
    def raw_synthesis(self):
        """Plain (no-prosody) synthesis of each segment's raw transcript into
        <name>_raw."""
        log.info(">>> Raw synthesis")
        out_audio = self.raw_audio_dir
        out_txt = self.raw_synth_dir / "transcription"
        out_audio.mkdir(parents=True, exist_ok=True)
        out_txt.mkdir(parents=True, exist_ok=True)
        seg_files = self._segment_files()
        try:
            nat_rate = wav_info(seg_files[0])[1] if seg_files else None
        except (OSError, ValueError):
            nat_rate = None
        for wav_path in seg_files:
            stem = wav_path.stem
            src = self.transcription_raw_dir / f"{stem}.txt"
            if not src.exists():
                log.warning("no raw transcript for %s; skipping raw synth", stem)
                continue
            text = src.read_text(encoding="utf-8").strip()
            (out_txt / f"{stem}.txt").write_text(text, encoding="utf-8")
            ssml = (
                "<speak version='1.0' xmlns='http://www.w3.org/2001/10/synthesis' "
                "xmlns:mstts=\"https://www.w3.org/2001/mstts\" xml:lang='fr-FR'>"
                f"<voice name='{self.cfg.azure_voice_name}'>{text}</voice></speak>"
            )
            out_path = out_audio / f"{stem}.wav"
            write_wav(out_path, self.tts.synthesize(ssml))
            # each segment's upload runs behind the synthesis of the next
            prefetch_segment(out_path, rate_expect=nat_rate, device=self.device)
        # the raw corpus, assembled on the device from the resident rows or
        # loaded and uploaded; the paths and rate are prepare_voice's, so that
        # the keys match
        if seg_files:
            raw_paths = [out_audio / f"{p.stem}.wav" for p in seg_files]
            prefetch_corpus([p if p.exists() else None for p in raw_paths], rate_expect=nat_rate, device=self.device)

    # 4 ------------------------------------------------------------------
    def measure_prosody_and_build_ssml(self):
        """The numerical core: ``prosody.measure`` on the device, then the
        three BDD CSVs."""
        log.info(">>> Measure prosody & build SSML")
        seg_files = self._segment_files()
        if not seg_files:
            log.error("No audio segments found!")
            return
        result = measure_voice(
            seg_files,
            self.textgrid_dir,
            self.raw_audio_dir,
            self.cfg.prosody,
            clean_word=self.pos_backend.remove_spurious_commas,
            pos_of_factory=self.pos_backend.pos_of_factory,
            device=self.device,
        )
        self.emit_measure_csvs(result)

    def emit_measure_csvs(self, result: MeasureResult):
        self.last_measure = result
        emit_measure_csvs(result, self.results_dir, self.cfg.azure_voice_name, self.cfg.prosody.inter_syntagme_pause_factor)

    # 5 ------------------------------------------------------------------
    def synthesize_and_merge(self):
        """Per-syntagme synthesis + exact-pause stitching. A chunk whose
        synthesis fails becomes silence with a warning, as in the reference."""
        log.info(">>> Synthesize & merge")
        for d in (self.xml_dir, self.audio_out, self.audio_ssml_dir):
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True, exist_ok=True)
        rows = _read_rows(self.bdd_syntagme_synth_csv)

        chunks: dict[int, Audio | None] = {}
        content_idx = 0
        with phase("merge/tts"):
            for row in rows:
                txt = (row.get("syntagme") or "").strip()
                if txt and _HAS_WORD.search(txt):
                    if txt == "...":
                        continue
                    (self.xml_dir / f"{content_idx:04d}.xml").write_text(row["ssml"], encoding="utf-8")
                    try:
                        audio = self.tts.synthesize(row["ssml"])
                        write_wav(self.audio_out / f"{content_idx:04d}.wav", audio)
                        chunks[content_idx] = audio
                    except Exception as e:  # noqa: BLE001 — the reference degrades to silence
                        log.warning("TTS failed for %r: %s", txt, e)
                        chunks[content_idx] = None
                    content_idx += 1

        sr = getattr(self.tts, "sample_rate", 44100)
        with phase("merge/stitch"):
            result = stitch_rows(rows, chunks, sr, self.cfg.prosody.end_punctuation_pause_ms)
        with phase("merge/write"):
            for seg, audio in result.segments.items():
                write_wav(self.audio_ssml_dir / f"{seg}.wav", audio)
            write_wav(self.results_dir / "OUT.wav", result.out)
        log.info("merged OUT.wav: %.1f s", result.out.duration_seconds)

    # 6 ------------------------------------------------------------------
    def export_training_json(self):
        """(text → tagged-SSML) training JSON + the cross-voice bdd.json."""
        log.info(">>> Export training JSON")
        rows = _read_rows(self.bdd_syntagme_ssml_csv)
        write_training_json(rows, self.results_dir / f"training_data_{self.name}.json")
        combine_training_data(self.out_dir / "results", self.out_dir / "results" / "bdd.json")

    # 7 ------------------------------------------------------------------
    def final_transcribe(self):
        """Re-align the merged OUT.wav → OUT.TextGrid against the known
        syntagme text, with the configured acoustic aligner (the energy
        aligner when the pipeline's aligner is ``energy`` or
        ``precomputed``)."""
        log.info(">>> Final transcribe")
        out_wav = self.results_dir / "OUT.wav"
        if not out_wav.exists():
            log.error("No OUT.wav found at %s", out_wav)
            return
        audio = read_wav(out_wav).to_mono()
        text = " ".join(
            (r.get("syntagme") or "").strip()
            for r in _read_rows(self.bdd_syntagme_synth_csv)
            if (r.get("syntagme") or "").strip()
        )
        if self.cfg.aligner in ("precomputed", "energy"):
            tg = EnergyAligner(device=self.device).align(audio, text)
        else:
            tg = self._aligner().align(audio, text)
        write_textgrid(tg, self.results_dir / "OUT.TextGrid")
        (self.results_dir / "transcription_final.txt").write_text(text, encoding="utf-8")

    # 8 ------------------------------------------------------------------
    def compare_breaks(self, tol_ms: int = 5):
        """Pause fidelity: expected SSML breaks against the silences of the
        final TextGrid."""
        log.info(">>> Compare breaks")
        rows = _read_rows(self.bdd_syntagme_synth_csv)
        report = compare_breaks(rows, read_textgrid(self.results_dir / "OUT.TextGrid"), tol_ms=tol_ms)
        with open(self.results_dir / "pause_comparison_full.csv", "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(
                f, fieldnames=["segment", "syntagme", "nat_voice_ms", "synth_voice_ms", "diff_ms", "ok", "match_quality"]
            )
            w.writeheader()
            for r in report.rows:
                w.writerow(r)
        log.info(
            "Breaks compared: %d; within ±%d ms: %d (%.1f%%); avg |diff| %.0f ms",
            report.total, tol_ms, report.within, 100.0 * report.within / max(report.total, 1), report.avg_abs_diff,
        )
        self.last_breaks = report
        return report

    # ------------------------------------------------------------------
    def step_fn(self, name: str):
        """The bound method of the step called ``name`` (one of STEP_NAMES)."""
        return dict(zip(self.STEP_NAMES, (
            self.preprocess,
            self.align_and_transcribe,
            self.raw_synthesis,
            self.measure_prosody_and_build_ssml,
            self.synthesize_and_merge,
            self.export_training_json,
            self.final_transcribe,
            self.compare_breaks,
        )))[name]

    def run(self) -> StepTimer:
        """The steps of ``cfg.steps_to_run`` (all eight by default), in order;
        then ``used_config.yaml`` and ``step_timings.jsonl`` in the results
        directory. Returns the step timer."""
        to_run = self.cfg.steps_to_run or self.STEP_NAMES
        timer = StepTimer()
        for name in self.STEP_NAMES:
            if name not in to_run:
                continue
            log.info("[%s] step: %s", self.name, name)
            try:
                with timer.step(name, voice=self.name):
                    self.step_fn(name)()
            except Exception:
                log.exception("Failed step %s", name)
                timer.dump(self.results_dir / "step_timings.jsonl")
                raise
        cfg_path = self.results_dir / "used_config.yaml"
        cfg_path.write_text(self.config_yaml, encoding="utf-8")
        timer.dump(self.results_dir / "step_timings.jsonl")
        log.info("Config saved to %s", cfg_path)
        return timer


def run_pipeline_for_voice(name: str, cfg: PipelineConfig, tts: TTSBackend | None = None, device="cuda"):
    """One voice through ``AudioPipeline.run`` with the reference's isolation contract: a failure
    in one voice is reported, not propagated."""
    logger = logging.getLogger()
    logger.info("--- Starting pipeline for: %s ---", name)
    try:
        AudioPipeline(name, cfg, tts=tts, device=device).run()
        logger.info("--- Finished pipeline for: %s ---", name)
        return True, name
    except Exception as e:  # noqa: BLE001
        logger.error("--- Pipeline failed for: %s ---", name)
        logger.exception(e)
        return False, name


def main(argv: list[str] | None = None):
    """``python -m prosody_control_french_tts_tpu_torch.core.pipeline
    --config config.yaml``: every voice of the config. With more than one
    voice and ``multiprocessing: true`` (the reference's process pool), the
    voices go through ``core.batch_runner.run_all_voices``: host steps voice
    by voice, one batched measure pass for all of them. Otherwise the voices
    run one after another."""
    import argparse

    from .config import load_config

    ap = argparse.ArgumentParser(description="Prosody-control pipeline (PyTorch)")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--voices", nargs="*", help="override voice_names")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # a card asked for and missing raises here, not once per voice
    cfg = load_config(args.config)
    setup_logging(cfg.out_path)
    voices = args.voices or cfg.voice_names
    if not voices:
        print("Missing 'voice_names' in config.yaml", file=sys.stderr)
        sys.exit(1)
    if cfg.multiprocessing and len(voices) > 1:
        from .batch_runner import run_all_voices

        cfg.voice_names = list(voices)
        results = run_all_voices(cfg, device=args.device)
    else:
        results = [run_pipeline_for_voice(v, cfg, device=args.device) for v in voices]
    failed = [n for ok, n in results if not ok]
    if failed:
        print(f"Some pipelines failed: {', '.join(failed)}", file=sys.stderr)
        sys.exit(1)


def measure_and_build_ssml(
    seg_files,
    textgrid_dir,
    raw_audio_dir,
    results_dir,
    settings: ProsodySettings,
    voice: str,
    factor: float,
    device="cuda",
) -> MeasureResult:
    """Measure one voice and write its three BDD CSVs into results_dir."""
    result = measure_voice(
        [Path(p) for p in seg_files],
        Path(textgrid_dir),
        Path(raw_audio_dir),
        settings,
        clean_word=fr_pos.remove_spurious_commas,
        pos_of_factory=None,
        device=device,
    )
    emit_measure_csvs(result, results_dir, voice, factor)
    return result


if __name__ == "__main__":
    main()

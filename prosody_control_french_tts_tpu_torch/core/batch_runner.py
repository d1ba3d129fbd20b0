"""Every voice of a config through the pipeline, with one batched measure
pass.

Port of the JAX package's ``core/batch_runner.py``. The reference runs
voices in an OS process pool, one pipeline (and one Whisper model) per
process (``multiprocessing: true``). Here the host steps run voice by voice,
and the measure step runs once for all voices:
``prosody.measure.measure_voices_batched`` puts every voice's segments
through one device pass per (padded length, rate) group, and each voice's
pipeline then only writes its CSVs.

A failure in one voice's host steps (before or after the measure step) is
reported and the other voices go on, as in the JAX package. One difference
is deliberate: the JAX package catches any failure of the batched pass and
measures the voices one by one instead. Here a failure of the batched pass
raises. On a card such a fallback would hide a fault of the batched packing
or of a kernel behind a slower path that still passes.
"""

from __future__ import annotations

import contextlib
import logging

from ..prosody.measure import MeasureResult, measure_voices_batched, prepare_voice
from .config import PipelineConfig
from .pipeline import AudioPipeline
from .profiling import StepTimer

log = logging.getLogger(__name__)

STEPS_BEFORE = AudioPipeline.STEP_NAMES[:3]
MEASURE = AudioPipeline.STEP_NAMES[3]  # "Measure & Build SSML"
STEPS_AFTER = AudioPipeline.STEP_NAMES[4:]


def measure_all_voices(pipes: list[AudioPipeline]) -> dict[str, MeasureResult]:
    """One batched measure pass over every voice's segments, on the first
    pipeline's device. Voices without segments are left out with a
    warning."""
    preps = {}
    for pipe in pipes:
        segs = pipe._segment_files()
        if not segs:
            log.warning("no segments for %s", pipe.name)
            continue
        preps[pipe.name] = prepare_voice(
            segs, pipe.textgrid_dir, pipe.raw_audio_dir, pipe.cfg.prosody,
            clean_word=pipe.pos_backend.remove_spurious_commas, pos_of_factory=pipe.pos_backend.pos_of_factory,
        )
    if not preps:
        return {}
    return measure_voices_batched(preps, pipes[0].cfg.prosody, device=pipes[0].device)


def run_all_voices(cfg: PipelineConfig, tts=None, device="cuda", timer: StepTimer | None = None) -> list[tuple[bool, str]]:
    """Every voice of ``cfg.voice_names`` through ``cfg.steps_to_run`` (all
    eight by default), the measure step batched over the voices. Returns
    (ok, voice) per voice; a batched measure pass that fails raises. As in
    the JAX package, the steps are called directly: no ``used_config.yaml``
    or ``step_timings.jsonl`` is written. ``timer`` records each step's
    seconds (voice ``"*"`` for the batched measure pass)."""

    def timed(name, voice):
        return timer.step(name, voice=voice) if timer is not None else contextlib.nullcontext()

    def call(pipe, name):
        with timed(name, pipe.name):
            pipe.step_fn(name)()

    pipes = []
    results: list[tuple[bool, str]] = []
    for name in cfg.voice_names:
        try:
            pipes.append(AudioPipeline(name, cfg, tts=tts, device=device))
        except Exception as e:  # noqa: BLE001 — per-voice isolation
            log.error("init failed for %s: %s", name, e)
            results.append((False, name))

    to_run = cfg.steps_to_run or AudioPipeline.STEP_NAMES
    alive: list[AudioPipeline] = []
    for pipe in pipes:
        try:
            for name in STEPS_BEFORE:
                if name in to_run:
                    call(pipe, name)
            alive.append(pipe)
        except Exception:  # noqa: BLE001 — per-voice isolation
            log.exception("pre-measure steps failed for %s", pipe.name)
            results.append((False, pipe.name))

    measured = {}
    if MEASURE in to_run and alive:
        with timed(MEASURE, "*"):
            measured = measure_all_voices(alive)

    for pipe in alive:
        try:
            if MEASURE in to_run:
                if pipe.name in measured:
                    pipe.emit_measure_csvs(measured[pipe.name])
                else:
                    log.error("No audio segments found for %s!", pipe.name)
            for name in STEPS_AFTER:
                if name in to_run:
                    call(pipe, name)
            results.append((True, pipe.name))
        except Exception:  # noqa: BLE001 — per-voice isolation
            log.exception("pipeline failed for %s", pipe.name)
            results.append((False, pipe.name))

    failed = [n for ok, n in results if not ok]
    if failed:
        log.error("Some pipelines failed: %s", ", ".join(failed))
    return results

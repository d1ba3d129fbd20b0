"""Step 4 of the voice pipeline, "Measure & Build SSML", in PyTorch.

Counterpart of ``AudioPipeline.measure_prosody_and_build_ssml`` and
``emit_measure_csvs`` of the JAX package's ``core/pipeline.py``: measure one
voice (``prosody.measure``) and write the three BDD CSVs of SSML with the
same columns, rows and bytes:

- ``BDD_ssml.csv``: one ``<speak>`` per segment;
- ``BDD_syntagme_ssml.csv``: one ``<speak>`` per syntagme, with ``<break>``;
- ``BDD_syntagme_for_synth.csv``: the same without ``<break>``.

The other steps of the eight-step driver are not ported yet. POS tagging is
the lexicon backend (``utils.fr_pos``), the JAX package's default.
"""

from __future__ import annotations

import csv
from pathlib import Path

from ..prosody.adjust import ProsodySettings
from ..prosody.measure import MeasureResult, measure_voice
from ..ssml import emit as ssml_emit
from ..utils import fr_pos

CSV_NAMES = ("BDD_ssml.csv", "BDD_syntagme_ssml.csv", "BDD_syntagme_for_synth.csv")


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

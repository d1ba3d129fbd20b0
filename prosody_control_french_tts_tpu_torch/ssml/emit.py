"""SSML tag emission — byte-compatible with the reference's formats.

Three artifact shapes (Code/audioPipeline.py:604-711):

- segment-level ``BDD_ssml.csv``: all of a segment's prosody pieces inside
  one ``<speak>`` with mstts leading/tailing silence pinned to 0;
- syntagme-level ``BDD_syntagme_ssml.csv``: one ``<speak>`` per syntagme
  (training data; keeps ``<break>``);
- synthesis ``BDD_syntagme_for_synth.csv``: like the former but without
  ``<break>`` (pauses are stitched as exact silence instead).

Plus the break-only SSML of Code/Preprocessing/gen_break_ssml.py:141-177.
"""

from __future__ import annotations

from ..utils.text import xml_escape
from .syntagme import MIN_PAUSE_THRESHOLD_MS

SSML_NS = "http://www.w3.org/2001/10/synthesis"
MSTTS_NS = "http://www.w3.org/2001/mstts"


def _break_duration(words: str, pause_ms: int, inter_syntagme_pause_factor: float) -> int:
    """Pause rendering rule (Code/audioPipeline.py:616-622): syntagmes
    ending in sentence punctuation keep the full pause; others are scaled
    by the inter-syntagme factor."""
    last_char = words[-1] if words else None
    if last_char is not None and last_char in ".?!":
        return int(pause_ms)
    return int(pause_ms * inter_syntagme_pause_factor)


def prosody_piece(
    words: str,
    pause_ms: int,
    pitch_pct: float,
    rate_pct: float,
    volume_pct: float,
    inter_syntagme_pause_factor: float = 1.0,
    include_break: bool = True,
) -> str:
    """One ``<prosody …>text[<break/>]</prosody>`` piece
    (Code/audioPipeline.py:606-625 formatting: ``%+.2f%%`` everywhere,
    breaks only for pauses ≥ 50 ms)."""
    text = xml_escape(words)
    pros = (
        f'<prosody pitch="{pitch_pct:+.2f}%" '
        f'rate="{rate_pct:+.2f}%" '
        f'volume="{volume_pct:+.2f}%">'
        f"{text}"
    )
    if include_break and pause_ms >= 50:
        pros += f'<break time="{_break_duration(words, pause_ms, inter_syntagme_pause_factor)}ms"/>'
    return pros + "</prosody>"


def segment_ssml(pieces: list[str], voice: str) -> str:
    """Segment-level <speak> with exact-zero Azure padding silences
    (Code/audioPipeline.py:633-644)."""
    return (
        f'<speak xmlns="{SSML_NS}" '
        f'xmlns:mstts="{MSTTS_NS}" '
        'version="1.0" xml:lang="fr-FR">'
        f'<voice name="{voice}">'
        '<mstts:silence type="Leading-exact" value="0"/>'
        + "".join(pieces)
        + '<mstts:silence type="Tailing-exact" value="0"/>'
        "</voice>"
        "</speak>"
    )


def syntagme_ssml(piece: str, voice: str) -> str:
    """Per-syntagme training <speak> (Code/audioPipeline.py:669-675)."""
    return (
        f'<speak xmlns="{SSML_NS}" '
        'version="1.0" xml:lang="fr-FR">'
        f'<voice name="{voice}">' + piece + "</voice></speak>"
    )


def syntagme_ssml_no_break(piece_no_break: str, voice: str) -> str:
    """Per-syntagme synthesis <speak> (Code/audioPipeline.py:694-704)."""
    return (
        f'<speak xmlns="{SSML_NS}" '
        f'xmlns:mstts="{MSTTS_NS}" '
        'version="1.0" xml:lang="fr-FR">'
        f'<voice name="{voice}">'
        '<mstts:silence type="Leading-exact" value="0"/>'
        + piece_no_break
        + '<mstts:silence type="Tailing-exact" value="0"/>'
        "</voice>"
        "</speak>"
    )


def break_only_ssml(aligned_sequence, voice: str = "fr-FR-HenriNeural") -> str:
    """Break-only SSML from an aligned (word|pause) sequence
    (Code/Preprocessing/gen_break_ssml.py:141-177, incl. the pretty-print)."""
    parts = []
    for kind, content in aligned_sequence:
        if kind == "word":
            parts.append(str(content))
        elif kind == "pause" and content >= MIN_PAUSE_THRESHOLD_MS:
            parts.append(f'<break time="{content}ms"/>')
    full_text = " ".join(parts)
    ssml = (
        f'<speak xmlns="{SSML_NS}" version="1.0" xml:lang="fr-FR">\n'
        f'    <voice name="{voice}">\n'
        f"        {full_text}\n"
        f"    </voice>\n"
        f"</speak>"
    )
    try:
        import xml.dom.minidom

        return xml.dom.minidom.parseString(ssml).toprettyxml(indent="  ")
    except Exception:
        return ssml

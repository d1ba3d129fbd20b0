"""TTS backend protocol.

The reference calls the Azure Speech SDK from three places
(get_synth.py:10, synthesize_ssml_voice.py:168,291, TTS_df.py:12), which
defines the boundary. Here that boundary is a protocol: anything with
``synthesize(ssml) -> Audio`` can back the pipeline: the Azure REST client
(``tts.azure``) in production, the deterministic fake in tests and on the
card. The SSML helpers below serve both.
"""

from __future__ import annotations

import re
from typing import Protocol, runtime_checkable

from ..utils.wavio import Audio


class TTSError(RuntimeError):
    """Synthesis failure; ``code`` mirrors Azure cancellation error codes
    (the reference special-cases 1007, synthesize_ssml_voice.py:217-228)."""

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


@runtime_checkable
class TTSBackend(Protocol):
    sample_rate: int

    def synthesize(self, ssml: str) -> Audio:  # pragma: no cover - protocol
        ...


_TAG = re.compile(r"<[^>]+>")
_BREAK = re.compile(r'<break\s+time="(\d+)ms"\s*/>')
_PROSODY = re.compile(
    r'<prosody[^>]*pitch="([+-]?[\d.]+)%"[^>]*rate="([+-]?[\d.]+)%"[^>]*volume="([+-]?[\d.]+)%"[^>]*>'
)


def extract_text(ssml: str) -> str:
    """Visible text content of an SSML document."""
    no_breaks = _BREAK.sub(" ", ssml)
    return " ".join(_TAG.sub(" ", no_breaks).split())


def extract_breaks_ms(ssml: str) -> list[int]:
    return [int(m.group(1)) for m in _BREAK.finditer(ssml)]


def extract_prosody(ssml: str) -> tuple[float, float, float]:
    """(pitch%, rate%, volume%) of the first prosody tag, 0s if absent."""
    m = _PROSODY.search(ssml)
    if not m:
        return 0.0, 0.0, 0.0
    return float(m.group(1)), float(m.group(2)), float(m.group(3))


def simplify_ssml(ssml: str, voice: str) -> str:
    """Plain-text fallback document: the reference's repair path for Azure
    error 1007 (synthesize_ssml_voice.py:217-228)."""
    text = extract_text(ssml)
    return (
        '<speak xmlns="http://www.w3.org/2001/10/synthesis" '
        'version="1.0" xml:lang="fr-FR">'
        f'<voice name="{voice}">{text}</voice></speak>'
    )

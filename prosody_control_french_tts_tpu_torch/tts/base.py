"""TTS backend protocol.

Anything with ``synthesize(ssml) -> Audio`` can back the pipeline: the
deterministic fake in tests and on the card, or a network backend passed in
by the caller (the Azure client is not ported).
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


_PROSODY = re.compile(
    r'<prosody[^>]*pitch="([+-]?[\d.]+)%"[^>]*rate="([+-]?[\d.]+)%"[^>]*volume="([+-]?[\d.]+)%"[^>]*>'
)


def extract_prosody(ssml: str) -> tuple[float, float, float]:
    """(pitch%, rate%, volume%) of the first prosody tag, 0s if absent."""
    m = _PROSODY.search(ssml)
    if not m:
        return 0.0, 0.0, 0.0
    return float(m.group(1)), float(m.group(2)), float(m.group(3))

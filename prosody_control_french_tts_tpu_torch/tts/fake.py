"""Deterministic fake TTS backend (numpy) for hermetic tests and runs.

A seeded glottal-buzz synthesizer whose output responds to the SSML it is
given, so the prosody measurement has something real to measure:

- duration ∝ syllable count, scaled by the ``rate`` percentage;
- F0 = 170 Hz shifted by the ``pitch`` percentage;
- amplitude scaled by the ``volume`` percentage;
- ``<break time="Xms"/>`` rendered as exact silence.

The micro-prosody of each piece is seeded from a SHA-1 of its text and the
backend's seed, so the same SSML gives the same samples everywhere.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from ..utils.wavio import Audio
from .base import extract_prosody

_TOKEN = re.compile(r'<break\s+time="(\d+)ms"\s*/>|<[^>]+>|([^<]+)')

BASE_F0 = 170.0
BASE_SYLLABLE_S = 0.18  # seconds of audio per (approximate) syllable


def _syllables(word: str) -> int:
    v = sum(1 for c in word.lower() if c in "aeiouyàâäéèêëîïôöùûü")
    return max(1, v)


class FakeBackend:
    def __init__(self, sample_rate: int = 44100, seed: int = 0):
        self.sample_rate = sample_rate
        self.seed = seed
        self.calls = 0

    def _voice(self, text: str, pitch_pct: float, rate_pct: float, volume_pct: float) -> np.ndarray:
        sr = self.sample_rate
        words = text.split()
        if not words:
            return np.zeros(0, np.float32)
        syl = sum(_syllables(w) for w in words)
        dur = syl * BASE_SYLLABLE_S / (1.0 + rate_pct / 100.0)
        n = max(int(dur * sr), int(0.05 * sr))
        # float32 elementwise (the output is rounded to PCM16 anyway)
        t = np.arange(n, dtype=np.float32) / np.float32(sr)
        f0 = BASE_F0 * (1.0 + pitch_pct / 100.0)
        h = int.from_bytes(hashlib.sha1((text + str(self.seed)).encode()).digest()[:4], "little")
        rng = np.random.default_rng(h)
        wobble = 1.0 + 0.02 * np.sin(2 * np.pi * (2.0 + (h % 5)) * t + np.float32(rng.uniform(0, 6.28)))
        # the phase accumulates in float64 (a float32 cumsum drifts over
        # long clips), then drops to float32 for the harmonic stack
        phase = (2 * np.pi * np.cumsum((f0 * wobble).astype(np.float64)) / sr).astype(np.float32)
        sig = np.zeros(n, np.float32)
        for k, a in ((1, 1.0), (2, 0.6), (3, 0.4), (4, 0.2), (5, 0.1)):
            sig += np.float32(a) * np.sin(np.float32(k) * phase)
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t + np.float32(rng.uniform(0, 6.28)))
        # soft attack/release so the stitcher's fades have something to act on
        ramp = min(n // 10, int(0.01 * sr))
        if ramp > 0:
            env[:ramp] *= np.linspace(0, 1, ramp)
            env[-ramp:] *= np.linspace(1, 0, ramp)
        amp = 0.25 * (1.0 + volume_pct / 100.0)
        return (amp * env * sig / 2.3).clip(-1, 1)

    def synthesize(self, ssml: str) -> Audio:
        self.calls += 1
        pitch, rate, volume = extract_prosody(ssml)
        pieces: list[np.ndarray] = []
        for m in _TOKEN.finditer(ssml):
            if m.group(1) is not None:  # break
                pieces.append(np.zeros(int(int(m.group(1)) * self.sample_rate / 1000), np.float32))
            elif m.group(2) and m.group(2).strip():
                pieces.append(self._voice(m.group(2).strip(), pitch, rate, volume))
        samples = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        return Audio(samples, self.sample_rate)

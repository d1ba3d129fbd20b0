"""A synthetic voice from a seed, laid out as the measure step reads it.

Used where the real French corpus is absent: the port's tests and
``chip_smoke.py``. Each segment is a glottal-pulse-like harmonic source
(harmonics at 1/h amplitude) following a moving F0 contour, with an
amplitude envelope per word, breath noise, and 200–700 ms pauses between
word groups. The layout under ``root``:

- ``audio/segment_ph<i>.wav``: the natural segments (PCM16);
- ``textgrids/segment_ph<i>.TextGrid``: word tiers with the silences;
- ``raw/segment_ph<i>.wav``: a "raw" synthetic rendering of each segment
  with a flat F0, another gain and another length.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .textgridio import word_tier_with_silences, write_textgrid
from .wavio import write_wav

WORDS = (
    "bonjour la voix change beaucoup le portrait du compositeur quelle belle journée "
    "nous avons parlé de musique et ils sont partis vers une maison grande"
).split()


def _render(word_spans, total_s, f0_of, gain, rate, rng):
    """Harmonic source on the given (start, end) word spans."""
    n = int(round(total_s * rate))
    t = np.arange(n) / rate
    f0 = np.zeros(n)
    env = np.zeros(n)
    for s, e in word_spans:
        i0, i1 = int(s * rate), min(int(e * rate), n)
        u = np.linspace(0.0, 1.0, i1 - i0, endpoint=False)
        f0[i0:i1] = f0_of(t[i0:i1], u)
        env[i0:i1] = np.sin(np.pi * u) ** 0.5
    phase = 2.0 * np.pi * np.cumsum(f0) / rate
    src = sum(np.sin(h * phase) / h for h in range(1, 11))
    x = gain * env * src / 2.0 + 0.003 * rng.normal(size=n)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def synth_voice(root, seed: int = 0, n_segments: int = 10, seconds=(8.0, 23.0), rate: int = 44100):
    """Write a synthetic voice under ``root``; returns (seg_files,
    textgrid_dir, raw_audio_dir)."""
    root = Path(root)
    audio, tgs, raw = root / "audio", root / "textgrids", root / "raw"
    for d in (audio, tgs, raw):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    seg_files = []
    for si in range(1, n_segments + 1):
        target = rng.uniform(*seconds)
        spans, words, t = [], [], 0.05
        group = 0
        while t < target - 0.3:
            d = rng.uniform(0.18, 0.45)
            w = WORDS[rng.integers(len(WORDS))]
            group += 1
            end_group = group >= rng.integers(2, 6)
            if end_group and rng.random() < 0.5:
                w += "," if rng.random() < 0.5 else "."
            spans.append((t, t + d))
            words.append(w)
            t += d + (rng.uniform(0.2, 0.7) if end_group else rng.uniform(0.0, 0.04))
            if end_group:
                group = 0
        total = t + 0.05
        base, swing, speed = rng.uniform(100, 200), rng.uniform(20, 80), rng.uniform(0.3, 1.2)
        f_nat = lambda tt, u: np.clip(base + swing * np.sin(2 * np.pi * speed * tt) + 30 * (1 - u), 100, 280)
        x = _render(spans, total, f_nat, rng.uniform(0.3, 0.8), rate, rng)
        name = f"segment_ph{si}"
        write_wav(audio / f"{name}.wav", x, rate)
        write_textgrid(
            word_tier_with_silences([(s, e, w) for (s, e), w in zip(spans, words)], len(x) / rate),
            tgs / f"{name}.TextGrid",
        )
        # raw rendering: flat F0, other gain, time-scaled
        k = rng.uniform(0.85, 1.15)
        flat = rng.uniform(140, 200)
        y = _render([(s * k, e * k) for s, e in spans], total * k, lambda tt, u: np.full_like(tt, flat),
                    rng.uniform(0.2, 0.9), rate, rng)
        write_wav(raw / f"{name}.wav", y, rate)
        seg_files.append(audio / f"{name}.wav")
    return seg_files, tgs, raw

"""POS backend of the pipeline: what the measure and align steps consume.

Counterpart of ``PosBackend`` and ``get_pos_backend`` of the JAX package's
``models/pos_tagger.py``. The port serves the ``lexicon`` backend (the
closed-class lexicon of ``utils.fr_pos``, the default); the ``contextual``
backend is a small trained transformer tagger that is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils import fr_pos


@dataclass
class PosBackend:
    """Per-token POS for chunk heads, the comma filter, and (contextual only)
    a sentence-aware pos_of factory for the syntagme pause filter (None →
    per-token default)."""

    first_token_pos: object
    remove_spurious_commas: object
    pos_of_factory: object = None


def get_pos_backend(name: str) -> PosBackend:
    """Config hook: "lexicon" → the fr_pos functions."""
    if name == "lexicon":
        return PosBackend(fr_pos.first_token_pos, fr_pos.remove_spurious_commas)
    if name == "contextual":
        raise NotImplementedError(
            "pos_backend 'contextual' (the trained tagger) is not ported to PyTorch yet "
            "(ROADMAP Queue 1 item 12); use 'lexicon'"
        )
    raise ValueError(f"unknown pos backend: {name!r} (use 'lexicon' or 'contextual')")

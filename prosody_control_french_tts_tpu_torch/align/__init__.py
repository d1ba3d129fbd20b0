"""Alignment: the ``Aligner`` protocol with the hermetic energy and
precomputed aligners and the acoustic CTC and Whisper aligners."""

from .levenshtein_merge import merge_textgrids  # noqa: F401
from .needleman_wunsch import needleman_wunsch  # noqa: F401

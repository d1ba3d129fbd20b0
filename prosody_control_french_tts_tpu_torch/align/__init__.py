"""Alignment: the ``Aligner`` protocol with the hermetic energy and
precomputed aligners and the acoustic CTC and Whisper aligners."""

"""Alignment: the ``Aligner`` protocol with the hermetic energy and
precomputed aligners."""

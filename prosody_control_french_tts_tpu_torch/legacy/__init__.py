"""Legacy BDD1→BDD5 chain (the reference's original 14-step pipeline).

The modern measure step supersedes this flow, but the reference keeps the
legacy chain as its historical data model (SURVEY.md §1: Voc class,
Code/pipeline_class_legacy.py:850-971) and several artifacts (BDD*.csv,
Needleman-Wunsch alignment files) are defined by it. This package rebuilds
it on the port's pitch tracker (kernels A and B on the card): same CSV
schemas, same math, no per-syntagme file re-reads.
"""

from .bdd import (  # noqa: F401
    SegmentRow,
    extract_segment_rows,
    align_rows,
    add_breaks,
    compute_pitch_adjustments,
    compute_loudness_adjustments,
    compute_rate_adjustments,
    build_ssml_fragments,
)
from .voc import Voc  # noqa: F401

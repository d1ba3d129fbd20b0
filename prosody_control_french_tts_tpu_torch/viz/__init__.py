"""Visualisation: plot-data computation + HTTP viewer (stdlib only)."""

from .plotdata import compute_plot_data, downsample  # noqa: F401
from .acoustic import plot_comparison  # noqa: F401

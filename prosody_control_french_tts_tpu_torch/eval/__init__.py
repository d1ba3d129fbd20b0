"""Evaluation of the pipeline's outputs (pause fidelity)."""

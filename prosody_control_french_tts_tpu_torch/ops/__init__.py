"""Tensor ops of the port: PCM, prefix sums, range maxima, loudness, pitch,
and the wrappers of the CUDA kernels."""

"""Tensor ops of the port: PCM, prefix sums, range maxima, loudness, pitch,
the STFT family, and the wrappers of the CUDA kernels."""

"""PyTorch/CUDA port of the JAX package of this repository, for NVIDIA Hopper.

The measure-and-SSML step of one voice runs here in PyTorch: Boersma pitch
(with hand-written CUDA kernels for the candidate selection and the Viterbi
path finder, ``csrc/``), BS.1770 loudness, the clamp/smooth math and the
three BDD CSVs. So does the LLM serving path of the SSML cascade
(``models/``): the decoder LM, its fused bfloat16 / int8 serving layout and
greedy decoding, with a hand-written CUDA kernel for the decode-step
attention over the packed KV caches. The layout mirrors the JAX package
(``ops/``, ``prosody/``, ``ssml/``, ``utils/``, ``core/``, ``models/``) so
each module's counterpart is easy to find. This package imports neither JAX
nor the JAX package.
"""

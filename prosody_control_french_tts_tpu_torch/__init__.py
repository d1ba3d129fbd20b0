"""PyTorch/CUDA port of the JAX package of this repository, for NVIDIA Hopper.

The measure-and-SSML step of one voice runs here in PyTorch: Boersma pitch
(with hand-written CUDA kernels for the candidate selection and the Viterbi
path finder, ``csrc/``), BS.1770 loudness, the clamp/smooth math and the
three BDD CSVs. So do the eight-step voice pipeline, the multi-voice runner
(``core.batch_runner``: one batched measure pass for every voice) and the
two denoisers of its Preprocess (``audio.denoise``, with a hand-written
mask-smoothing kernel, and ``audio.separate``), and the LLM serving and
LoRA training paths of the SSML cascade (``models/``), with hand-written
CUDA kernels for their attention and fused cross-entropy. The layout
mirrors the JAX package (``ops/``, ``prosody/``, ``ssml/``, ``utils/``,
``core/``, ``models/``, ``audio/``, ``tts/``) so each module's counterpart
is easy to find. This package imports neither JAX nor the JAX package.
"""

#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: the measure-and-SSML step, the
eight-step voice pipeline, the multi-voice pipeline with its denoisers, the
standalone frame and cumsum kernels, the LLM
serving path, the LLM training path (LoRA fine-tuning, at L 512 with
kernel G and at L 1024 / 768 with the flash attention), the acoustic
aligners (Whisper, CTC) alone and in the eight-step pipeline, the break
predictors' serving path (the BERT tagger behind the SSML HTTP service), and
the contextual POS tagger with the evaluation layer, and the training
halves of the aligners and the separator.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with an NVIDIA H100. It

1. builds the port's CUDA kernels from ``prosody_control_french_tts_tpu_torch/csrc``
   (``nvcc``, one process per source, into ``build/torch_kernels/``);
2. synthesises a full-width voice from the seed (10 segments of 8–23 s at
   44.1 kHz, word TextGrids, a raw rendering of each segment) and runs
   ``measure_and_build_ssml(..., device="cuda")`` with kernel A's and B's
   launch counts set to 0 just before and read just after;
3. checks that result: finite rows, the three CSVs, every kernel launched,
   a 200 Hz tone read as 200 Hz, and a small voice measured on the card
   agreeing with the plain PyTorch path on the CPU;
4. runs the eight-step voice pipeline, ``AudioPipeline(name, cfg,
   device="cuda")``, on a brute recording made of the same 10 segments
   joined by 1.5 s of zeros: Preprocess must split it back into 10 segments;
   each segment then gets its transcript from the synth word lists, and the
   other seven steps run with the fake TTS and the energy aligner, cold, then
   all eight warm with every kernel count set to 0 just before and read just
   after (A and B once per measure call, C/D/E never: they have no caller),
   then once more under torch.profiler; checks every artifact of the JAX
   package's end-to-end test, and one synthesized wav per SSML chunk (a
   failed synthesis would otherwise pass as silence), prints the break report, per-step seconds,
   audio-s/s and the device-busy share; and runs the eight steps on a
   2-segment voice on the card and on the CPU, holding the silence ranges,
   the aligner's TextGrids and the segment / syntagme / pause columns equal
   and the adjustment columns within 0.05 points;
5. holds the frame gather (TPU kernels C and D, one CUDA kernel behind
   ``extract_frames``, ``extract_frames_aligned`` and ``frames_op``) and the
   chunk cumsum (kernel E) equal to their plain versions at the JAX tests'
   shapes and at the measure voice's (frames B 10, T 1,040,384, F 4,715,
   W 880; the cumsum of its x² padded to [16, 1,040,384]), and times each
   there, its plain version and one library formulation as CUDA-graph
   replays;
6. holds kernels A and B against their plain versions on the measure path's
   own tensors (A within 1e-6, B exactly);
7. times A, its plain version and ``torch.topk`` as CUDA-graph replays (A
   over two copies of r in turn, L2 cold; one copy and CUDA events around
   eager calls printed beside), B and its plain version between CUDA events,
   and gives B's chain floor: the least time its dependent chains can take,
   from a shuffle's and a float add's latency measured on the card;
8. serves the LLM at the full width of ``LLMConfig.qwen25_7b()`` in
   bfloat16, weights made on the card from the seed: ``fuse_decode_params``
   then ``greedy_generate_fused`` (16 prompts of 64 tokens, 128 new tokens),
   with kernel F's launch count set to 0 just before and read just after
   (layers × 127), cold and warm, and checks the tokens; holds F against its
   plain version (2e-2 in bfloat16, 2e-5 in float32), shows that it ignores
   rows beyond pos and gives the same bits over two calls, and times it by
   its kernels' durations under torch.profiler (the host's launch overhead
   exceeds the kernel's time);
9. serves the JAX bench's geometry (12 layers, dim 896; 64 prompts of 64
   tokens, 256 new) in bfloat16 and with the int8b weight stream, and holds
   the int8b tree's tokens against its dequantized tree's in float32;
10. runs the two-stage cascade with tiny models on the card and on the CPU;
11. trains: LoRA steps at the full width and depth of
    ``LLMConfig.qwen25_7b()`` (``attn_impl="vmem"``, ``fused_qkv``, rank 8,
    bfloat16 frozen base, B 4, L 512, fused loss; one warm step and four more,
    kernel G counted layers x steps forward and backward, kernel H steps each,
    frozen leaves unchanged, losses falling), then at the JAX bench's training
    geometry (12 layers, dim 896, B 8, L 512, ``scan_steps``);
12. holds the loss curve of ("vmem", "fused") on the card against ("dot",
    "dense") on the card and on the CPU at a small float32 shape (5e-4);
13. holds kernels G and H, forward and backward, against their plain versions
    on tensors captured from those steps and on edge shapes (G in bfloat16 on
    its tensor-core kernels and upcast to float32 on its CUDA-core kernels),
    shows that G's bfloat16 backward gives the same bits twice at the 7B
    shape, that H's bfloat16 backward does too and that H allocates less than
    an [N, V] tensor, and times the four
    launches, their plain versions and the library calls
    (``scaled_dot_product_attention``, ``F.cross_entropy`` of the dense
    logits), forward and backward, as replays of CUDA graphs between CUDA
    events;
14. trains at the cascade's real lengths with ``attn_impl="flash"`` (the
    counterpart of the upstream Pallas TPU flash-attention op, reading the
    model's q and its grouped K/V in place through ``flash_attention_gqa``):
    ``qwen25_7b`` at full width and depth, B 2, L 1024 (stage A's length),
    and the bench geometry at B 8, L 768 (stage B's), with the flash
    attention counted layers x steps forward and backward, kernel G, the dot
    path and the K/V repeat never; prints the 7B step's peak memory beside
    one step of the dot path on the same model; holds ("flash", "fused")
    against ("dot", "dense") on the card and the CPU at L 256; holds the
    flash attention against its plain version (the K/V repeat, the
    transposes and the upstream op's plain recurrence) on the captured 7B and
    bench tensors (bf16 and upcast to float32, at ``FA_LIMITS``: forward and
    dq per (b, head), dk and dv per (b, KV head)), shows its bf16 backward
    gives the same bits twice at the 7B shape, and times it beside its plain
    version and ``scaled_dot_product_attention(is_causal=True)`` on K/V
    repeated to all heads in [B, H, L, hd] as CUDA-graph replays. The
    trainers' step splits (torch.profiler) come last of all.

While the kernels build, one more ``nvcc -Xptxas -v`` compile each of
``csrc/vmem_attn.cu``, ``csrc/fused_ce.cu``, ``csrc/decode_attn.cu``,
``csrc/viterbi.cu``, ``csrc/flash_attention.cu``, ``csrc/pitch_candidates.cu``,
``csrc/chunk_cumsum.cu``, ``csrc/mask_ema.cu`` and ``csrc/ctc_viterbi.cu``
reports the registers, spills and shared memory of kernel G's bfloat16
kernels and of all of kernels H's, F's, B's, the flash attention's, A's
(each per-lane instantiation), E's, mask_ema's and ctc_viterbi's.

15. (run right after phase 4) the multi-voice pipeline, ``multiprocessing:
    true``, at full width: four brute recordings at 44.1 kHz of 10 segments
    joined by 1.5 s of zeros (seeds 0, 2, 3 with segments of 8–23 s, in the
    T 1,040,384 bucket; seed 4 with segments of 4–11 s, in the T 516,096
    bucket: two (T, rate) groups, 616.7 s), ``denoise: mask`` (the
    MaskNet separator on the card), the fake TTS and the energy aligner,
    driven as bench.py's multi-voice cell: ``run_all_voices`` with Preprocess
    alone, the transcripts, then the other seven steps; cold, then warm with
    every count set to 0 just before and read just after (A and B once per
    group, 2 each; the per-voice measure pass never); checks that every voice
    returns ok, that each denoised recording splits back into 10 segments,
    every artifact of the end-to-end test for every voice, and each voice's
    batched rows against a per-voice ``measure_voice`` on the card (1e-3,
    equal syntagmes); holds ``mask_ema`` bit-equal to its plain version on
    the mask of the 159.5 s recording, reads its fix-up count there and
    times it beside its byte bound and one chain a bin's floor; holds ``denoise`` and
    ``MaskSeparator.separate`` on the card against the CPU on a 20 s excerpt
    (1e-5 of the peak; 30 dB SI-SNR); runs a 2-voice set in two groups with
    ``denoise: spectral`` on the card (``mask_ema`` once per voice) and on
    the CPU, holding the silence ranges, TextGrids and segment / syntagme /
    pause columns equal and the adjustments within 0.05 points; prints the
    four-voice run's audio-s/s warm and cold with its per-step split, the
    batched measure step beside four per-voice ``measure_voice`` calls (each
    profiled, with its device-busy share), kernel B at S = 30 beside S = 10,
    and the denoisers' seconds per audio-second on the card.

16. the packaged Whisper aligner (``WhisperAligner()``, the JAX bench's
    whisper_align shape: 12 held-out synthetic sentences, seed 900000,
    transcript-free ``align_batch``) cold and warm, with the warm call split
    into mel, encoder with cross K/V, greedy loop (steps taken) and DTW spans
    (CUDA events) and its device-busy share (torch.profiler); the JAX
    package's gate (``boundary_error_ms`` over 8 held-out sentences, seed
    555000: < 80 ms, word accuracy > 0.85); card against CPU on three clips
    (equal words, boundaries within 20 ms);
17. the decode pass (``make_greedy_spans_fn``) at ``WhisperConfig.small()``
    widths with random weights made on the card, batch 16, the full 128
    steps: ms a decode step, seconds a call, peak device memory (timing
    only);
18. the packaged CTC aligner: the JAX package's gate (6 held-out sentences,
    seed 555000: < 80 ms) and card against CPU on three clips;
19. the eight steps on a brute recording of synthetic French sentences (10
    segments of 8–23 s, the sentences 0.5–0.9 s apart, the segments 1.5 s of
    zeros apart, resampled to 44.1 kHz with ``utils.wavio.resample``) with
    ``aligner: whisper`` (transcript-free) cold and warm, each on a fresh copy
    of the voice, and with ``aligner: ctc`` (the sentences as raw
    transcripts): launches counted (A and B once, ``ctc_viterbi`` once a
    segment and once for Final Transcribe), the artifacts checked, the
    segments' words against the gold spans; then ``ctc_viterbi`` held bit for
    bit to its plain version on every call captured in phases 18 and 19, and
    timed on the Final Transcribe call beside its plain version, its bytes
    bound and its chain's floor, with ``ctc_forced_align`` timed as a whole
    call beside the kernel alone.

20. the break-predictor serving path at bert-base width (``BertConfig()``:
    hidden 768, 12 layers, 12 heads, ffn 3072, L 128; bench.py's 512-token
    tokenizer; bfloat16; weights from the seed): ``BreakTagger`` and
    ``SentenceEncoder`` on the card against the plain CPU path on 8
    sentences (largest logit difference, the share of words whose BREAK
    decision agrees; a decision may differ only where the CPU margin is at
    most 0.05); ``sentences_per_second`` at bench.py's geometry (B 256, L
    128, 100 forwards) with ms a batch (CUDA events), the device-busy share
    (torch.profiler) and the share of the bf16 peak at bench.py's operation
    count; the HTTP service under bench.py's load (96 clients x 12
    sentences, every bucket warmed, ``serve(port=0)``), batched (max_batch
    64, 4 ms) and unbatched (max_batch 1): sentences/s, p50/p99, the
    batcher's stats, every response 200 with a ``<speak`` document; a few
    requests through the prosody head (SSML with ``<prosody pitch/rate/
    volume>``); ``run_break_experiment`` (tiny, 2 runs, 2 epochs) and
    ``run_bilstm_experiment`` (seq_len 1, 2 epochs) on the ``bdd.json`` that
    phase 15's Export JSON wrote; ten ``train_tagger`` steps at bert-base
    width (B 64): finite losses, ms a step. This path runs no hand kernel.
    Then the sequence that once hung a serving turn (a batched predictor
    closed, then an unbatched one built and served) twice more, each
    predictor capturing its row buckets' CUDA graphs when it is built.

21. (run right after phase 15) the contextual POS tagger and the evaluation
    layer: the packaged tagger (``ContextualTagger(device="cuda")``, d_model
    96, 2 layers) tags the JAX suite's 800 held-out silver sentences on the
    card and on the CPU (tags equal wherever the CPU's top-2 margin is at
    least 1e-3; the JAX suite's accuracy gates), with ``tag_tokens``'
    sentences/s; ``train_pos_tagger`` at the JAX CLI's settings (16,000
    sentences, 900 steps, B 256): finite, falling losses, ms a step, the
    retrained tagger through the same gates, its checkpoint saved and
    loaded back with equal tags; the eight steps with ``pos_backend:
    contextual`` on a brute recording like phase 4's (10 segments, 159.5 s)
    whose transcripts are made of ambiguous forms, cold and warm (A and B
    once each, every artifact), beside a lexicon run on the same recording
    (the pauses and commas each keeps that the other drops), and a 2-segment
    contextual voice on the card and the CPU; ``evaluate_all`` over phase
    15's four voices and this voice (no voice in error; F0 RMSE, break F1,
    WER; the DTW's cost matrices and peak memory), one voice against the
    CPU; ``extract_features`` over phase 15's 40 segments (A and B once per
    wav); YIN against the Boersma tracker on one segment; and
    ``corpus_agreement_report`` on three synthetic clips (``ctc_viterbi``
    once per clip, every summary field filled). Every A and B call of the
    contextual warm run, ``extract_features`` (75 Hz floor, 591 lags) and
    the Boersma contour (60 Hz, 738 lags) is held against its plain version.

22. (run after phase 20) the training halves of the aligners and the
    separator: ``train_ctc_aligner`` at the default geometry (dim 128, 2
    layers, 4 heads, 80 mels, V 47) on a corpus that ``build_natural_corpus``
    gathers from a voice of synthetic French segments (12 segments of up to
    19.5 s, 3 epochs): the losses fall, ``ctc_loss`` counts 2 launches a step,
    the checkpoint reloads through ``CTCAligner(weights_path=...)`` and aligns
    every word, the first step on the card agrees with the CPU's (loss 1e-3
    relative; updated weights at most 2.5 lr apart, at most 5 % moved the
    other way); ``ctc_loss`` held to its plain version (loss 1e-5 relative,
    gradient 1e-5 x max(1, loss / 100)) on every captured step and on edge
    cases (label_len 0 and 1, input_len < T, repeated labels, an infeasible
    alignment, one frame, S 1,025 / 2,049 / 4,095, and 4,097, which must
    raise), and timed at the largest step (forward and backward launches as
    CUDA-graph replays, beside its plain loops and ``F.ctc_loss``, with its
    bound and chain floors); ``pretrain_ctc.pretrain`` and
    ``pretrain_masknet`` as the recipes stand, gates on; the Whisper recipe
    at ``synth_fr_config()`` cut to 192 sentences and 2 epochs, gates read
    and printed (the whole recipe: ``tools/aligner_training_phase.py``). Each
    recipe's ms a step by CUDA events; every checkpoint in a temporary
    directory.

23. (run last) the umbrella command line, ``python -m
    prosody_control_french_tts_tpu_torch <command>`` called in this process
    (``__main__.main``), and the host front ends it reaches: ``run`` on
    phase 2's 10-segment voice laid out with its TextGrids (precomputed
    aligner, fake TTS; warm, A and B once each), ``legacy`` on the same voice
    with its raw renderings and their TextGrids (A and B once per pitch
    track: the BDD2 stage's (wav, floor) tracks), a 2-segment voice through
    ``legacy`` on the card and the CPU (adjustments 0.05 points), ``sync``,
    ``corpus``, ``analyze`` and ``abtest`` on the run's output; the viewer
    (``VizService`` over the run's natural and raw segments, served on an
    ephemeral port, preloaded by four threads: A and B once per plot), its
    routes, one plot card vs CPU (the unrounded spectrogram's amplitude 1e-5 of the
    peak and dB 1e-3 within 40 dB of it, F0 1 %) and
    ``device_trace`` around one plot (the Chrome trace names A's and B's
    kernels); ``train_stage(ckpt_dir=...)`` on the card, 3 epochs, keep 2,
    the newest checkpoint restored bit-equal into a fresh model that
    generates the same text; ``praat_pitch`` with ``sinc_refine_steps=2`` on
    the card and the CPU; then the HF converters at published widths with
    weights drawn on the card under HF's names: Qwen2.5-7B's geometry in
    bfloat16 through ``qwen2_to_torch`` (float32, then cast to bfloat16)
    and the fused serving tree to 8
    greedy tokens (kernel F: 28 x 7 launches), and whisper-base's through
    ``whisper_to_torch`` into ``WhisperAligner`` (a 30 s window encoded, 4
    greedy tokens, timed after 4 of warm-up, equal to the teacher-forced
    argmax). Alone:
    ``tools/cli_phase.py``.

It prints the card's name and power limit, one line per kernel, a
``{"kernels": [...]}`` line with fifteen entries (mask_ema, ctc_viterbi and
ctc_loss, which replace no TPU kernel, among them; A's and B's rows carry
``cli_launches``, F's the converted 7B tree's), and last ``{"ok": true,
"device": {...}}``. Any failed phase raises, and the script exits non-zero.
Without a card it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import csv
import importlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TOL_A = 1e-6  # kernel A vs plain: |lag_f|, |strength| (valid exact)
TOL_B = 0.0  # kernel B vs plain: f0 equal in every frame
TOL_F_BF16 = 2e-2  # kernel F vs plain, bfloat16: |err| <= tol + tol * |plain|
TOL_F_F32 = 2e-5  # kernel F vs plain, the same tensors upcast to float32
FULL_SEGMENTS = 10  # the full-width voice: 10 segments of 8–23 s
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # H100 SXM dense peaks

# kernels G and H vs plain. Float32: sum order and expf only. bfloat16: G's
# outputs reach a few units (one rounding of 4.0 is 1.6e-2); its backward
# rounds ds and p to bfloat16 before the products as the TPU kernel does,
# autograd of the plain version rounds every intermediate instead; H rounds
# the backward's coefficients and dh to bfloat16 (2^-9 relative each).
TOL_G_F32 = 2e-5  # forward, absolute
TOL_G_BF16 = 5e-2  # forward, absolute
TOL_G_GRAD_F32 = 1e-5  # dq, dk, dv: relative to the plain gradient's largest element
TOL_G_GRAD_BF16 = 3e-2
TOL_H_F32 = 1e-5  # rows: |err| <= tol + tol * |plain| at D 256
TOL_H_EXTREME = 1e-4  # rows at logits scaled x12
TOL_H_WIDE = 1e-4  # rows at full width: float32 sums of 3,584 products in another order
TOL_H_GRAD_F32 = 1e-5  # dh at D 256: relative to the plain gradient's largest element
TOL_H_GRAD_WIDE = 1e-4  # dh at full width, float32: sums over 152,064 columns in another order
TOL_H_GRAD_BF16 = 2e-2
TOL_PARITY = 5e-4  # loss curves, relative
# the flash attention (FA) vs plain in bfloat16. Forward, row by row: for
# each output row (hd values), |got - plain| <= TOL_FA_BF16 * (|plain| +
# FA_FLOOR * the largest row |plain|), |.| the row's 2-norm. p is rounded
# against the running max of 64-key tiles, the plain version's against
# 128-key tiles, and the outputs round once more, each about 2^-9 relative and
# independent over the keys, so a row's error stays a fixed share of the row
# however many keys it averages (G's absolute limit does not: a row of L keys
# has |o| ~ L^-1/2, 0.05 at L 1,024). A key tile dropped from a row of n keys
# moves it by about 8 / sqrt(n) of itself (0.25 at n 1,024). Gradients, per
# (b, h): the 2-norm of the kernel's error against the plain version in
# float32 on the upcast inputs, over the plain bf16 version's own error
# against it, <= TOL_FA_GRAD_BF16. dq_i = sum_j ds_ij k_j with sum_j ds_ij = 0
# cancels keys' shared part, but the roundings of di and ds do not: where
# keys share a large part, dq's bf16 error is a large share of dq in both
# versions (a row measure read 0.19 on the 7B step's tensors), so the kernel
# is held to the plain version's accuracy, not to dq's size. The two errors
# come from the same rounding points, in other tiles. Float32 is held to G's
# float32 limits, 2.5e3 times below a long row's |o|. The tensors are in the
# model's layout [B, L, heads, hd]: per (b, head) is per query head for the
# forward and dq, per KV head for dk and dv.
TOL_FA_BF16 = 2**-6  # forward, row by row
TOL_FA_GRAD_BF16 = 2.0  # dq, dk, dv: error over the plain version's error
FA_FLOOR = 1e-3
# kernel G's bfloat16 times (ms; 7B shape, bench shape) of the CUDA-core
# design that the tensor-core kernels replaced: PERF.md section 6, H100 80GB
# HBM3 at 700 W, CUDA-graph replays with L2 cold. Recorded, not measured by
# this script: printed beside the kernel lines only, never in the kernels line.
G_PREVIOUS_MS = {"fwd": (0.4496, 0.3040), "bwd": (2.191, 1.404)}
# kernel H's bfloat16 times (ms; 7B shape, bench shape) of the wmma design
# that the wgmma kernels replaced, likewise from PERF.md section 6 (H100 80GB
# HBM3 at 700 W): printed beside the kernel lines only.
H_PREVIOUS_MS = {"fwd": (19.90, 2.176), "bwd": (28.18, 3.281)}
# the flash attention's bfloat16 times (ms; 7B shape, bench shape) of the
# mma.sync design on [B, H, L, hd] with K/V repeated that the wgmma kernels
# replaced, likewise from PERF.md section 6 (H100 80GB HBM3 at 700 W): printed
# beside the kernel lines only.
FA_PREVIOUS_MS = {"fwd": (0.0881, 0.0556), "bwd": (0.3646, 0.2311)}
# kernel F's times (ms; 7B geometry, bench geometry) of the design with one
# block per (b, KV head) that the clustered kernel replaced, and kernel B's (ms,
# measure voice) of the one-warp design: PERF.md section 6, H100 80GB HBM3 at
# 700 W. Recorded, not measured by this script: printed beside the kernel lines only.
F_PREVIOUS_MS = (0.0213, 0.0208)
B_PREVIOUS_MS = 5.015
# kernel A's time (ms, measure voice; CUDA events around eager calls) of the
# design with k rounds of warp argmax, and kernel E's (ms, [16, 1,040,384];
# CUDA-graph replay) of the design with one 1024-thread block a chunk:
# PERF.md section 6, H100 80GB HBM3 at 700 W. Recorded, not measured by this
# script: printed beside the kernel lines only.
A_PREVIOUS_MS = 0.0688
E_PREVIOUS_MS = 0.1127
# kernel F's serving launches for the ptxas report: dtype code, hd, B, KV heads, S
F_SERVING_LAUNCHES = {"7b": (1, 128, 16, 4, 192), "bench": (1, 64, 64, 2, 320)}
SM_REGISTERS, SM_SMEM = 65536, 233472  # per SM of an H100: registers; shared memory with 1 KB reserved per block
TRAIN_STEPS = 4  # optimizer steps after the warm one

KERNEL_A = dict(
    name="pitch_candidates",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/pitch_candidates.cu",
    replaces="prosody_control_french_tts_tpu/ops/pallas_kernels.py:307",
)
KERNEL_B = dict(
    name="viterbi",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/viterbi.cu",
    replaces="prosody_control_french_tts_tpu/ops/viterbi_pallas.py:180",
)
KERNEL_F = dict(
    name="decode_attn",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/decode_attn.cu",
    replaces="prosody_control_french_tts_tpu/ops/decode_attn.py:73",
)
KERNEL_G_FWD = dict(
    name="vmem_attn_fwd",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/vmem_attn.cu",
    replaces="prosody_control_french_tts_tpu/ops/vmem_attn.py:140",
)
KERNEL_G_BWD = dict(KERNEL_G_FWD, name="vmem_attn_bwd", replaces="prosody_control_french_tts_tpu/ops/vmem_attn.py:170")
KERNEL_H_FWD = dict(
    name="fused_ce_fwd",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/fused_ce.cu",
    replaces="prosody_control_french_tts_tpu/ops/fused_ce.py:120",
)
KERNEL_H_BWD = dict(KERNEL_H_FWD, name="fused_ce_bwd", replaces="prosody_control_french_tts_tpu/ops/fused_ce.py:162")
# the upstream Pallas TPU flash-attention op (the installed jax package's file),
# reached from prosody_control_french_tts_tpu/models/llm.py:207-212
UPSTREAM_FA = "jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNEL_FA_FWD = dict(
    name="flash_attn_fwd",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/flash_attention.cu",
    replaces=f"{UPSTREAM_FA}:589",
)
KERNEL_FA_BWD = dict(KERNEL_FA_FWD, name="flash_attn_bwd", replaces=f"{UPSTREAM_FA}:941", also_replaces=f"{UPSTREAM_FA}:1287")
KERNEL_C = dict(
    name="frames",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/frames.cu",
    replaces="prosody_control_french_tts_tpu/ops/pallas_kernels.py:75",
)
KERNEL_D = dict(KERNEL_C, name="frames_aligned", replaces="prosody_control_french_tts_tpu/ops/pallas_kernels.py:183")
# not a TPU kernel: the spectral gate's time smoothing, a lax.scan in the JAX package
KERNEL_MASK_EMA = dict(
    name="mask_ema",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/mask_ema.cu",
    replaces="prosody_control_french_tts_tpu/audio/denoise.py:49",
)
KERNEL_E = dict(
    name="chunk_cumsum",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/chunk_cumsum.cu",
    replaces="prosody_control_french_tts_tpu/ops/pallas_kernels.py:362",
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


PTXAS_SOURCES = ("vmem_attn.cu", "fused_ce.cu", "decode_attn.cu", "viterbi.cu", "flash_attention.cu", "pitch_candidates.cu",
                 "chunk_cumsum.cu", "mask_ema.cu", "ctc_viterbi.cu")


def start_ptxas_report():
    """Start ``nvcc -Xptxas -v`` on each of :data:`PTXAS_SOURCES` (the build's
    own flags) in the background; :func:`print_ptxas_report` reads them."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in PTXAS_SOURCES:
        out = kernels.BUILD_DIR / f"ptxas_{name[:-3]}.o"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(kernels.CSRC / name), "-o", str(out)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def ptxas_rows(text: str, pattern: str) -> dict:
    """{kernel name (template arguments in <>): registers, spills, stack} of
    the entry functions whose mangled name matches ``pattern`` (group 1 the
    name, later groups optional template arguments)."""
    report, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if hit:
            m = re.search(pattern, hit.group(1))
            name = None
            if m:
                args = [g for g in m.groups()[1:] if g]
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
                report.setdefault(name, {})
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            report[name].update(stack=int(spill.group(1)), spill_stores=int(spill.group(2)), spill_loads=int(spill.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            report[name]["registers"] = int(regs.group(1))
    return report


def torch_sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` that fit an SM of the H100 by registers (allocated
    8 a thread at a time), by shared memory (1 KB reserved per block) and by
    the SM's 2,048 threads and 32 blocks."""
    return min(SM_REGISTERS // (-(-registers // 8) * 8 * threads), SM_SMEM // (smem + 1024), 2048 // threads, 32)


def print_ptxas_report(procs, lib) -> None:
    """Eight lines: registers, spills and stack of each bfloat16 kernel of G,
    of every kernel of H, of F, of B, of the flash attention and of every
    instantiation of A, E and ctc_viterbi (from ptxas), the dynamic shared memory each
    asks for at launch (``vmem_attn_bf16_smem_bytes``, ``fused_ce_smem_bytes``,
    ``decode_attn_smem_bytes`` at the serving shapes, ``viterbi_smem_bytes``,
    ``flash_attn_smem_bytes``, ``pitch_candidates_smem_bytes`` at the measure
    path's lags: the sizes the launchers pass) and, for H, F, B, the flash
    attention, A and E, the blocks that fit an SM by registers and shared
    memory (``ops/fused_ce.py``'s plans count one)."""
    texts = {}
    for name, proc in zip(PTXAS_SOURCES, procs):
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc -Xptxas -v {name} failed:\n{text}")
        texts[name] = text
    report = {k: v for k, v in ptxas_rows(texts["vmem_attn.cu"], r"(vmem_attn_(?:fwd|bwd)\w*?)(?:ILi(\d+)E|E)").items()
              if "bf16" in k or "reduce" in k}
    for name, row in report.items():
        hd = re.search(r"<(\d+)>", name)
        if hd:
            row["dynamic_smem"] = lib.vmem_attn_bf16_smem_bytes(0 if "fwd" in name else 1 if "dq" in name else 2, int(hd.group(1)))
    if not report:
        raise SystemExit(f"no bfloat16 kernel of G in the ptxas report:\n{texts['vmem_attn.cu'][-2000:]}")
    print("ptxas: kernel G bfloat16 kernels: " + json.dumps(report))
    report = ptxas_rows(texts["fused_ce.cu"], r"(fused_ce_(?:fwd|combine|coef|dh)\w*?_kernel)(?:ILi(\d+)E)?")
    for name, row in report.items():
        bf16 = "bf16" in name
        cols = re.search(r"<(\d+)>", name)
        threads = 384 if bf16 else 256
        row["dynamic_smem"] = 0 if "combine" in name else lib.fused_ce_smem_bytes(1 if bf16 else 0, int(cols.group(1)) if cols else 256)
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], threads, row["dynamic_smem"])
    if not any("bf16" in k for k in report):
        raise SystemExit(f"no bfloat16 kernel of H in the ptxas report:\n{texts['fused_ce.cu'][-2000:]}")
    print("ptxas: kernel H kernels: " + json.dumps(report))
    report = ptxas_rows(texts["decode_attn.cu"], r"(decode_attn_cluster_kernel)I(13__nv_bfloat16|f)Li(\d+)E")
    from prosody_control_french_tts_tpu_torch.ops import decode_attn

    sms = torch_sm_count()
    for name, (dtype, hd, B, kv, S) in F_SERVING_LAUNCHES.items():
        C = decode_attn.split_plan(B, kv, S, sms)
        key = f"decode_attn_cluster_kernel<{'13__nv_bfloat16' if dtype == 1 else 'f'},{hd}>"
        if key not in report:
            raise SystemExit(f"no {key} in the ptxas report of decode_attn.cu:\n{texts['decode_attn.cu'][-2000:]}")
        row = report[key]
        row[f"blocks_per_cluster_{name}"] = C
        row[f"dynamic_smem_{name}"] = lib.decode_attn_smem_bytes(dtype, hd, S, C)
        row[f"blocks_per_sm_{name}"] = blocks_per_sm(row["registers"], 128, row[f"dynamic_smem_{name}"])
    print("ptxas: kernel F kernels: " + json.dumps({k.replace("13__nv_bfloat16", "bf16").replace("<f,", "<f32,"): v for k, v in report.items()}))
    report = ptxas_rows(texts["viterbi.cu"], r"(viterbi_kernel)ILi(\d+)E")
    if not report:
        raise SystemExit(f"no kernel of B in the ptxas report:\n{texts['viterbi.cu'][-2000:]}")
    for name, row in report.items():
        row["dynamic_smem"] = lib.viterbi_smem_bytes(int(re.search(r"<(\d+)>", name).group(1)))
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], 128, row["dynamic_smem"])
    print("ptxas: kernel B kernels: " + json.dumps(report))
    report = ptxas_rows(texts["flash_attention.cu"], r"(flash_(?:fwd|dq|dkv)_(?:bf16|f32))ILi(\d+)E")
    if len(report) != 12:
        raise SystemExit(f"{len(report)} of the 12 flash-attention kernels in the ptxas report:\n{texts['flash_attention.cu'][-2000:]}")
    for name, row in report.items():
        bf16 = "bf16" in name
        row["dynamic_smem"] = lib.flash_attn_smem_bytes(0 if "fwd" in name else 1 if "dq" in name else 2,
                                                        int(re.search(r"<(\d+)>", name).group(1)), int(bf16))
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], 384 if bf16 else 256, row["dynamic_smem"])
    print("ptxas: flash attention kernels: " + json.dumps(report))
    from prosody_control_french_tts_tpu_torch.ops import pitch

    g = pitch._geometry(1 << 20, 44100.0, pitch.PitchParams())
    report = ptxas_rows(texts["pitch_candidates.cu"], r"(pitch_candidates_kernel)ILi(\d+)E")
    if len(report) != 32:
        raise SystemExit(f"{len(report)} of the 32 kernels of A in the ptxas report:\n{texts['pitch_candidates.cu'][-2000:]}")
    for row in report.values():
        row["dynamic_smem"] = lib.pitch_candidates_smem_bytes(g["min_lag"], g["max_lag"])
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], 256, row["dynamic_smem"])
    print(f"ptxas: kernel A kernels (<lags per lane>; shared memory at lags [{g['min_lag']}, {g['max_lag']})): "
          + json.dumps(report))
    report = ptxas_rows(texts["chunk_cumsum.cu"], r"(chunk_cumsum_kernel)")
    if len(report) != 1:
        raise SystemExit(f"no kernel of E in the ptxas report:\n{texts['chunk_cumsum.cu'][-2000:]}")
    for row in report.values():
        row["dynamic_smem"] = 0
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], 128, 0)
    print("ptxas: kernel E kernels: " + json.dumps(report))
    report = ptxas_rows(texts["mask_ema.cu"], r"(ema_(?:speculate|fixup))ILb(\d)E")
    if len(report) != 4:
        raise SystemExit(f"{len(report)} of the 4 mask_ema kernels in the ptxas report:\n{texts['mask_ema.cu'][-2000:]}")
    for name, row in report.items():
        speculate = "speculate" in name
        row["static_smem"] = (32 + 1) * 257 * 4 if speculate else 4 * 256 * 4  # the chunk slots; the fix-up warps' chunks
        row["blocks_per_sm"] = blocks_per_sm(row["registers"], 32 if speculate else 128, row["static_smem"])
    print("ptxas: mask_ema kernels (<backward>): " + json.dumps(report))
    report = ptxas_rows(texts["ctc_viterbi.cu"], r"(ctc_viterbi_kernel)ILi(\d+)E")
    if len(report) != 4:
        raise SystemExit(f"{len(report)} of the 4 ctc_viterbi kernels in the ptxas report:\n{texts['ctc_viterbi.cu'][-2000:]}")
    tf = lib.ctc_viterbi_tile_frames(CTC_VOCAB)
    for name, row in report.items():
        k = int(re.search(r"<(\d+)>", name).group(1))
        row["max_states"] = min(8 * 256 * k, 16383)  # 8 blocks of at most 256 threads
        # a block of 8 warps: the ring and 8 warps' edge slots (the backtrack's windows are smaller)
        row[f"dynamic_smem_v{CTC_VOCAB}_8_warps"] = 3 * tf * CTC_VOCAB * 4 + (tf + 1) * 8 * 16
    print(f"ptxas: ctc_viterbi kernels (<states a thread>; ring tiles of {tf} frames at V {CTC_VOCAB}; static "
          f"shared memory: the edge slots from the block before): " + json.dumps(report))


def alu_latency_ns(lib) -> float:
    """The latency of one dependent float add or max on this card (ns), as
    ``viterbi_chain_floor`` measures it."""
    return viterbi_chain_floor(lib, 2, 1)["alu_ns"]


def viterbi_chain_floor(lib, F: int, K: int) -> dict:
    """The least time kernel B's dependent chains can take at [., F, K]:
    F - 1 forward steps, each a broadcast of psi (a shuffle), a subtract,
    ceil(log2 K) levels of max and an add, then F - 1 backtrack steps of one
    shuffle each. The latencies of a dependent shuffle and of a dependent
    float add or max are measured on this card by ``viterbi_latency_probe``
    (one warp, 2^20 dependent steps, CUDA events)."""
    import math

    import torch

    from prosody_control_french_tts_tpu_torch.ops import kernels

    out = torch.empty(32, device="cuda")
    steps = 1 << 20

    def probe(op):
        return cuda_ms(lambda: kernels.check(lib.viterbi_latency_probe(out.data_ptr(), op, steps, kernels.stream_ptr(out)),
                                             "viterbi_latency_probe"), reps=3)

    shfl_ms = probe(0) / steps
    alu_ms = probe(1) / (2 * steps)
    levels = math.ceil(math.log2(K)) if K > 1 else 0
    floor = (F - 1) * (shfl_ms + (levels + 2) * alu_ms) + (F - 1) * shfl_ms
    return dict(chain_floor_ms=floor, shfl_ns=shfl_ms * 1e6, alu_ns=alu_ms * 1e6,
                chain_floor=f"({F} - 1) x (shfl {shfl_ms * 1e6:.2f} ns + ({levels} + 2) x add/max {alu_ms * 1e6:.2f} ns) "
                            f"+ ({F} - 1) x shfl, latencies measured on this card")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Wrap a module function to keep the arguments of its calls (the last
    ``keep`` of them, or all) and their results (``results``, likewise, or
    none with ``results=False``, so that a large result is freed when its
    caller drops it), and count them (``count``)."""

    def __init__(self, module, name, keep=None, results=True):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.calls = collections.deque(maxlen=keep)
        self.results = collections.deque(maxlen=keep if results else 0)
        self.count = 0

    def __enter__(self):
        def wrapper(*a, **k):
            self.count += 1
            self.calls.append((a, k))
            out = self.orig(*a, **k)
            self.results.append(out)
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Timed(Capture):
    """Capture that sums the wall seconds of its calls (``seconds``); the
    wrapped function must end its own device work."""

    def __enter__(self):
        self.seconds = 0.0
        super().__enter__()
        inner = getattr(self.module, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(self.module, self.name, timed)
        return self


class GradCapture(Capture):
    """Capture that also keeps the gradient that reaches each call's result
    (``calls`` holds ``[args, grad or None]``)."""

    def __enter__(self):
        def wrapper(*a, **k):
            self.count += 1
            out = self.orig(*a, **k)
            rec = [a, None]
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__(1, g.detach()))
            self.calls.append(rec)
            return out

        setattr(self.module, self.name, wrapper)
        return self


def profile_device(fn):
    """fn() under torch.profiler → (wall ms, {kernel or copy name: [device
    ms, count]}). One stream, so device times do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        # device-side rows that are no kernel or copy: the profiler's own buffer
        # requests, and the optimizer's annotation mirrored onto the stream
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith(("Activity Buffer", "Optimizer.")):
            continue
        slot = by_name.setdefault(ev.name[:90], [0.0, 0])
        slot[0] += ev.time_range.elapsed_us() / 1e3
        slot[1] += 1
    return wall_ms, by_name


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of one fn(): the summed durations of every kernel
    and copy that ``reps`` calls launch (torch.profiler), over ``reps``. Host
    gaps between launches do not count, so a wrapper whose Python overhead
    exceeds its kernel's time is still timed by its kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    for attempt in range(3):
        _, by_name = profile_device(run)
        total = sum(t for t, _ in by_name.values())
        if total > 0:
            return total / reps
        print(f"note: torch.profiler recorded no device time (attempt {attempt + 1} of 3)")
    raise SystemExit("torch.profiler recorded no device time")


def profile_measure(fn) -> dict:
    """One warm measure step under torch.profiler: wall time, the device
    time of every kernel and copy (busy share = their sum / wall) and the
    heaviest of them by name."""
    wall_ms, by_name = profile_device(fn)
    device_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms > 0 else None,
        "top_device_ms": [[k, round(t, 4), n] for k, (t, n) in top],
    }


def read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# the eight-step voice pipeline
# ---------------------------------------------------------------------------

PIPE_GAP_S = 1.5  # zeros between the segments of the brute recording
SSML_TAG = re.compile(r'<prosody pitch="[+-]\d+\.\d{2}%" rate="[+-]\d+\.\d{2}%" volume="[+-]\d+\.\d{2}%">')


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def build_brute_voice(base: Path, name: str, seed: int, n_segments: int, seconds=(8.0, 23.0)):
    """``utils.synth`` segments joined by PIPE_GAP_S of zeros into
    ``Data/voice/<name>/brute/segment.wav``. Returns (per-segment
    transcripts from the synth word lists, audio seconds of the recording)."""
    import numpy as np

    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice
    from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav, write_wav

    seg_files, tg_dir, _ = synth_voice(base / "synth", seed=seed, n_segments=n_segments, seconds=seconds)
    parts, texts = [], []
    for p in seg_files:
        a = read_wav(p)
        parts += [np.asarray(a.samples, np.float32), np.zeros(int(PIPE_GAP_S * a.rate), np.float32)]
        texts.append(" ".join(iv.mark.strip() for iv in read_textgrid(tg_dir / f"{p.stem}.TextGrid").tiers[0] if iv.mark.strip()))
    x = np.concatenate(parts[:-1])
    brute = base / "Data" / "voice" / name / "brute"
    brute.mkdir(parents=True)
    write_wav(brute / "segment.wav", x, a.rate)
    return texts, x.size / a.rate


def pipeline_config(base: Path, name: str, pos_backend: str = "lexicon"):
    from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig

    return PipelineConfig.from_dict({
        "data_dir": "Data/voice", "out_dir": "Out", "voice_names": [name], "azure_voice_name": "fr-FR-DeniseNeural",
        "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
        "tts_backend": "fake", "aligner": "energy", "pos_backend": pos_backend,
    }, base)


def run_steps(pipe, steps) -> tuple:
    """``pipe.run()`` over ``steps`` (None: all eight) → (step records,
    wall seconds to the end of the device's work)."""
    pipe.cfg.steps_to_run = steps
    sync(pipe.device)
    t0 = time.perf_counter()
    timer = pipe.run()
    sync(pipe.device)
    return timer.records, time.perf_counter() - t0


def drive_voice(base: Path, name: str, texts, device, pos_backend: str = "lexicon") -> tuple:
    """Preprocess, the transcripts, then the other seven steps → (pipeline,
    step records, wall seconds)."""
    from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
    from prosody_control_french_tts_tpu_torch.prosody.measure import segment_sort_key

    pipe = AudioPipeline(name, pipeline_config(base, name, pos_backend), device=device)
    pre, pre_s = run_steps(pipe, ["Preprocess"])
    segs = sorted((pipe.voice_dir / "audio").glob("*.wav"), key=segment_sort_key)
    if len(segs) != len(texts):
        raise SystemExit(f"pipeline {name}: the silence split gave {len(segs)} segments of {len(texts)} ({pipe.last_split})")
    pipe.transcription_raw_dir.mkdir(parents=True, exist_ok=True)
    for seg, text in zip(segs, texts):
        (pipe.transcription_raw_dir / f"{seg.stem}.txt").write_text(text, encoding="utf-8")
    rest, rest_s = run_steps(pipe, pipe.STEP_NAMES[1:])
    return pipe, pre + rest, pre_s + rest_s


def check_pipeline_artifacts(pipe, n_segments: int, run_files: bool = True, aligner: str = "energy") -> None:
    """The artifacts of the JAX package's end-to-end test
    (tests/test_pipeline_e2e.py), each present and well formed.
    ``run_files``: also ``step_timings.jsonl`` and ``used_config.yaml``
    (with the run's ``aligner``), which ``AudioPipeline.run`` writes (the
    multi-voice runner does not)."""
    import numpy as np

    from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    res, s = pipe.results_dir, pipe.cfg.prosody
    for path in (pipe.bdd_ssml_csv, pipe.bdd_syntagme_ssml_csv, pipe.bdd_syntagme_synth_csv):
        if not path.exists():
            raise SystemExit(f"pipeline: {path.name} missing")
    rows = read_csv(pipe.bdd_syntagme_ssml_csv)
    if not {"segment", "syntagme", "pause", "ssml"} <= set(rows[0]) or len({r["segment"] for r in rows}) != n_segments:
        raise SystemExit("pipeline: BDD_syntagme_ssml.csv has the wrong columns or segments")
    text_rows = [r for r in rows if r["syntagme"].strip()]
    if not text_rows or not all(SSML_TAG.search(r["ssml"]) for r in text_rows):
        raise SystemExit("pipeline: a syntagme row lacks its <prosody> tag")
    if not all('<break time="' in r["ssml"] for r in rows if not r["syntagme"].strip() and int(float(r["pause"])) >= 50):
        raise SystemExit("pipeline: a pause row lacks its <break>")
    up = (2 ** (s.pitch_semitones / 12) - 1) * 100
    dn = (2 ** (-s.pitch_semitones * s.pitch_lower_clip_factor / 12) - 1) * 100
    for r in pipe.last_measure.rows:
        if not (dn - 1e-3 <= r.raw_pitch <= up + 1e-3 and abs(r.raw_volume) <= s.volume_pct + 1e-3
                and -s.rate_percent * 1.5 - 1e-3 <= r.raw_rate <= s.rate_percent + 1e-3):
            raise SystemExit(f"pipeline: adjustments outside their clamps: {r}")
    sm = [r.pitch_smooth for r in pipe.last_measure.rows]
    if any(abs(b - a) > s.max_jump_percent + 1e-4 for a, b in zip(sm, sm[1:])):
        raise SystemExit("pipeline: the smoothed pitch jumps past max_jump_percent")
    xmls = sorted(pipe.xml_dir.glob("*.xml"))
    if len(xmls) != len([r for r in read_csv(pipe.bdd_syntagme_synth_csv) if re.search(r"\w", r["syntagme"]) and r["syntagme"].strip() != "..."]):
        raise SystemExit(f"pipeline: {len(xmls)} xml files")
    # a chunk whose synthesis fails becomes silence with a warning and no wav
    # (Synthesize+Merge): one wav per xml file shows that every chunk was voiced
    wavs = sorted(p.stem for p in pipe.audio_out.glob("*.wav"))
    if wavs != [p.stem for p in xmls]:
        raise SystemExit(f"pipeline: {len(wavs)} synthesized wavs for {len(xmls)} xml files")
    if len(list(pipe.raw_audio_dir.glob("*.wav"))) != n_segments:
        raise SystemExit("pipeline: Raw Synthesis did not voice every segment")
    if any("<break" in p.read_text(encoding="utf-8") for p in xmls):
        raise SystemExit("pipeline: an xml file of the synthesis CSV holds a <break>")
    out = read_wav(res / "OUT.wav")
    if out.duration_seconds < 2.0 or not np.isfinite(out.samples).all():
        raise SystemExit(f"pipeline: OUT.wav {out.duration_seconds:.2f} s")
    if len(list(pipe.audio_ssml_dir.glob("segment_ph*.wav"))) != n_segments:
        raise SystemExit("pipeline: segmented_audio does not hold one wav per segment")
    j = json.loads((res / f"training_data_{pipe.name}.json").read_text(encoding="utf-8"))
    if set(j) != {"x", "y"} or set(j["y"]) != {"parsed_sequence", "stripped_ssml", "raw_ssml"} or not j["y"]["parsed_sequence"]:
        raise SystemExit("pipeline: training JSON schema")
    if pipe.name not in json.loads((pipe.out_dir / "results" / "bdd.json").read_text(encoding="utf-8")):
        raise SystemExit("pipeline: bdd.json lacks the voice")
    if sum(1 for iv in read_textgrid(res / "OUT.TextGrid").tiers[0] if iv.mark.strip()) < 5:
        raise SystemExit("pipeline: OUT.TextGrid holds fewer than 5 words")
    if not (res / "transcription_final.txt").read_text(encoding="utf-8").strip():
        raise SystemExit("pipeline: empty transcription_final.txt")
    cmp_rows = read_csv(res / "pause_comparison_full.csv")
    if not cmp_rows or not {"segment", "nat_voice_ms", "synth_voice_ms", "diff_ms"} <= set(cmp_rows[0]):
        raise SystemExit("pipeline: pause_comparison_full.csv")
    if not run_files:
        return
    steps = [json.loads(line)["step"] for line in (res / "step_timings.jsonl").read_text().splitlines()]
    if not steps or not (res / "used_config.yaml").read_text(encoding="utf-8").startswith(f"aligner: {aligner}"):
        raise SystemExit("pipeline: step_timings.jsonl or used_config.yaml")


def kernel_counts() -> dict:
    """The kernel wrappers' launch counts, and the calls of the per-voice
    measure pass (``run_measure_device``)."""
    from prosody_control_french_tts_tpu_torch.ops import candidates, chunk_cumsum, frames, mask_ema, viterbi
    from prosody_control_french_tts_tpu_torch.prosody import measure

    return {"pitch_candidates": candidates.launches, "viterbi": viterbi.launches, "frames": frames.launches,
            "chunk_cumsum": chunk_cumsum.launches, "mask_ema": mask_ema.launches,
            "run_measure_device": measure.run_measure_device_calls}


def reset_kernel_counts() -> None:
    from prosody_control_french_tts_tpu_torch.ops import candidates, chunk_cumsum, frames, mask_ema, viterbi
    from prosody_control_french_tts_tpu_torch.prosody import measure

    candidates.launches = viterbi.launches = frames.launches = chunk_cumsum.launches = mask_ema.launches = 0
    measure.run_measure_device_calls = 0


def per_step(records) -> dict:
    return {r["step"]: r["seconds"] for r in records}


def small_voice_card_vs_cpu(small: Path, seed: int, dev, label: str, pos_backend: str = "lexicon",
                            transcripts=None) -> None:
    """A 2-segment brute voice (3-5 s segments) through the eight steps on the
    card and on the CPU: equal silence ranges, TextGrids and segment /
    syntagme / pause columns, adjustments within 0.05 points. ``transcripts``
    (optional) rewrites the synth word lists before the run."""
    texts2, small_s = build_brute_voice(small / "card", "small", seed, 2, seconds=(3.0, 5.0))
    build_brute_voice(small / "cpu", "small", seed, 2, seconds=(3.0, 5.0))
    if transcripts is not None:
        texts2 = transcripts(texts2)
    p_card, _, _ = drive_voice(small / "card", "small", texts2, dev, pos_backend)
    p_cpu, _, _ = drive_voice(small / "cpu", "small", texts2, "cpu", pos_backend)
    if p_card.last_split != p_cpu.last_split:
        raise SystemExit(f"{label}: silence ranges card {p_card.last_split} != CPU {p_cpu.last_split}")
    for tg in sorted(p_cpu.textgrid_dir.glob("*.TextGrid")):
        if (p_card.textgrid_dir / tg.name).read_bytes() != tg.read_bytes():
            raise SystemExit(f"{label}: TextGrid {tg.name} differs between card and CPU")
    cols = lambda p: [(r["segment"], r["syntagme"], r["pause"]) for r in read_csv(p.bdd_syntagme_ssml_csv)]  # noqa: E731
    if cols(p_card) != cols(p_cpu):
        raise SystemExit(f"{label}: segment / syntagme / pause columns differ between card and CPU")
    adj_err = max(max(abs(a.pitch_smooth - b.pitch_smooth), abs(a.rate_smooth - b.rate_smooth), abs(a.raw_volume - b.raw_volume))
                  for a, b in zip(p_card.last_measure.rows, p_cpu.last_measure.rows))
    if adj_err > 0.05:
        raise SystemExit(f"{label}: card vs CPU adjustments differ by {adj_err} points")
    same_csv = p_card.bdd_syntagme_ssml_csv.read_bytes() == p_cpu.bdd_syntagme_ssml_csv.read_bytes()
    same_out = (p_card.results_dir / "OUT.TextGrid").read_bytes() == (p_cpu.results_dir / "OUT.TextGrid").read_bytes()
    print(f"{label} ({small_s:.1f} s, 2 segments) card vs CPU: ranges, TextGrids and segment/syntagme/pause columns equal; "
          f"adjustments max |diff| {adj_err:.2e} points; BDD_syntagme_ssml.csv byte-equal {same_csv}; OUT.TextGrid byte-equal {same_out}")


def pipeline_phase(tmp: Path, seed: int, card: str, device="cuda") -> dict:
    """Phase 4 of the module docstring. Returns the kernel counts of the warm
    run."""
    import torch

    from prosody_control_french_tts_tpu_torch.core import profiling

    dev = torch.device(device)
    name = "brute_voice"
    base = tmp / "pipeline"
    t0 = time.perf_counter()
    texts, audio_s = build_brute_voice(base, name, seed, FULL_SEGMENTS)
    print(f"pipeline voice: {FULL_SEGMENTS} segments joined by {PIPE_GAP_S} s of zeros, {audio_s:.1f} s of audio, "
          f"made in {time.perf_counter() - t0:.1f} s")
    profiling.reset_phases()
    pipe, cold, cold_s = drive_voice(base, name, texts, dev)
    cold_phases = dict(profiling.PHASES)
    print(f"pipeline preprocess: {len(pipe.last_split)} segments from the brute recording, ranges (ms) {pipe.last_split}")

    reset_kernel_counts()
    profiling.reset_phases()
    warm, warm_s = run_steps(pipe, None)
    counts = kernel_counts()
    warm_phases = dict(profiling.PHASES)
    print(f"pipeline warm run launches: {json.dumps(counts)}")
    if counts["pitch_candidates"] != 1 or counts["viterbi"] != 1:
        raise SystemExit(f"pipeline: kernels A and B must launch once per measure call, got {counts}")
    if counts["frames"] or counts["chunk_cumsum"] or counts["mask_ema"]:
        raise SystemExit(f"pipeline: kernels C/D/E have no caller on this path and the identity denoiser no mask_ema, got {counts}")
    check_pipeline_artifacts(pipe, FULL_SEGMENTS)
    rep = pipe.last_breaks
    print(f"pipeline breaks: {rep.total} compared, {rep.within} within ±5 ms ({100.0 * rep.within / max(rep.total, 1):.1f} %), "
          f"mean |diff| {rep.avg_abs_diff:.1f} ms, mean match quality {rep.avg_match_quality:.2f}")
    trace = profile_measure(lambda: pipe.run())

    # card against CPU on a 2-segment voice
    small_voice_card_vs_cpu(tmp / "pipeline_small", seed + 1, dev, "pipeline small voice")

    print(f"pipeline eight steps (warm): {warm_s:.3f} s, {audio_s / warm_s:.1f} audio-s/s; cold {cold_s:.3f} s, "
          f"{audio_s / cold_s:.1f} audio-s/s; card={card}")
    print("pipeline steps warm (s): " + json.dumps(per_step(warm)))
    print("pipeline steps cold (s): " + json.dumps(per_step(cold)))
    print("pipeline phases warm: " + json.dumps({k: round(v, 4) for k, v in sorted(warm_phases.items())}))
    print("pipeline phases cold: " + json.dumps({k: round(v, 4) for k, v in sorted(cold_phases.items())}))
    print("profile (warm pipeline run): " + json.dumps(trace))
    return counts


# ---------------------------------------------------------------------------
# the multi-voice pipeline (multiprocessing: true) and its denoisers
# ---------------------------------------------------------------------------

# (voice, seed, segment seconds): three voices in the T 1,040,384 bucket, one
# in the T 516,096 bucket; two (T, rate) groups, 616.7 s of audio
MULTI_VOICES = (("mv_a", 0, (8.0, 23.0)), ("mv_b", 2, (8.0, 23.0)), ("mv_c", 3, (8.0, 23.0)), ("mv_d", 4, (4.0, 11.0)))
TOL_BATCHED = 1e-3  # batched rows vs per-voice rows (the JAX package's tests/test_batch_runner.py)
# the denoisers, card vs CPU on the 20 s excerpt. The card read 4.47e-7
# (8.0e-7 of the peak) and 69.2 dB; the limits leave 2.5x and 14 dB of room,
# tighter than the CPU tests' limits against JAX (1e-5 of the peak, 30 dB),
# so that a card-only precision fault (TF32 left on in the float32 Dense or
# a LayerNorm) shows
TOL_DENOISE = 2e-6  # spectral gate: max |diff| over the input's peak
MIN_SEPARATE_SI_SNR = 55.0  # MaskNet separator: SI-SNR of the card's output against the CPU's, dB
EXCERPT_S = 20.0


def multi_voice_config(base: Path, names, steps, denoise: str):
    from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig

    return PipelineConfig.from_dict({
        "data_dir": "Data/voice", "out_dir": "Out", "voice_names": list(names), "azure_voice_name": "fr-FR-DeniseNeural",
        "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
        "tts_backend": "fake", "aligner": "energy", "multiprocessing": True, "denoise": denoise, "steps_to_run": steps,
    }, base)


def drive_all_voices(base: Path, texts: dict, device, denoise: str, timer=None) -> tuple:
    """``run_all_voices`` with Preprocess alone, the transcripts from the synth
    word lists, then ``run_all_voices`` with the other seven steps (as
    bench.py's multi-voice cell) → (the pipelines of the second call by voice,
    the pipelines of the first, wall seconds to the end of the device's work)."""
    import torch

    from prosody_control_french_tts_tpu_torch.core import batch_runner
    from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
    from prosody_control_french_tts_tpu_torch.prosody.measure import segment_sort_key

    dev = torch.device(device)
    pipes = []
    sync(dev)
    t0 = time.perf_counter()
    for steps in (["Preprocess"], AudioPipeline.STEP_NAMES[1:]):
        with Capture(batch_runner, "AudioPipeline") as made:
            res = batch_runner.run_all_voices(multi_voice_config(base, texts, steps, denoise), device=dev, timer=timer)
        if sorted(res) != sorted((True, n) for n in texts):
            raise SystemExit(f"multi-voice ({denoise}, {dev}): voices failed: {res}")
        pipes.append({p.name: p for p in made.results})
        if steps == ["Preprocess"]:
            for name, want in texts.items():
                p = pipes[0][name]
                segs = sorted((p.voice_dir / "audio").glob("*.wav"), key=segment_sort_key)
                if len(segs) != len(want):
                    raise SystemExit(f"multi-voice {name}: the split of the denoised recording gave {len(segs)} "
                                     f"segments of {len(want)} ({p.last_split})")
                p.transcription_raw_dir.mkdir(parents=True, exist_ok=True)
                for seg, text in zip(segs, want):
                    (p.transcription_raw_dir / f"{seg.stem}.txt").write_text(text, encoding="utf-8")
    sync(dev)
    return pipes[1], pipes[0], time.perf_counter() - t0


def rows_close(a, b, tol: float) -> float:
    """Max |difference| of raw_pitch, raw_volume, raw_rate and pitch_smooth
    over two row lists with equal syntagmes; raises where they differ."""
    if len(a) != len(b) or any(x.syntagme != y.syntagme for x, y in zip(a, b)):
        raise SystemExit("batched and per-voice rows differ in their syntagmes")
    err = max((abs(getattr(x, f) - getattr(y, f)) for x, y in zip(a, b)
               for f in ("raw_pitch", "raw_volume", "raw_rate", "pitch_smooth")), default=0.0)
    if err >= tol:
        raise SystemExit(f"batched rows differ from per-voice rows by {err} (tol {tol})")
    return err


def si_snr_db(est, ref) -> float:
    """Scale-invariant SNR of est against ref, dB (the JAX package's
    audio/separate.py:si_snr_db)."""
    import numpy as np

    ref = ref - ref.mean()
    est = est - est.mean()
    s = np.dot(est, ref) / (np.dot(ref, ref) + 1e-9) * ref
    e = est - s
    return float(10.0 * np.log10((np.dot(s, s) + 1e-9) / (np.dot(e, e) + 1e-9)))


def check_a_b(calls_a, calls_b, label: str) -> tuple[float, float]:
    """Holds every captured call of kernels A and B to its plain version on
    the same card tensors: A's valid flags equal and its lag_f and strength
    within TOL_A, B's f0 equal in every frame. Returns the max |err| of A and
    of B over the calls."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import candidates, viterbi

    err_a = err_b = 0.0
    for (r, k, min_lag, max_lag, vth), _ in calls_a:
        got = candidates.topk_parabolic(r, k, min_lag, max_lag, vth)
        want = candidates.topk_parabolic_plain(r, k, min_lag, max_lag, vth)
        if not torch.equal(got[2], want[2]):
            raise SystemExit(f"kernel A ({label}, r {tuple(r.shape)}): valid differs from its plain version")
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
        if err > TOL_A:
            raise SystemExit(f"kernel A ({label}, r {tuple(r.shape)}): max |err| {err} > {TOL_A}")
        err_a = max(err_a, err)
    for (delta, lf, voiced, freq, vuv, jump), _ in calls_b:
        got = viterbi.viterbi_path(delta, lf, voiced, freq, vuv, jump)
        want = viterbi.viterbi_path_plain(delta, lf, voiced, freq, vuv, jump)
        err = float((got - want).abs().max())
        if err > TOL_B:
            raise SystemExit(f"kernel B ({label}, {tuple(delta.shape)}): {int((got != want).sum())} frames differ "
                             f"from its plain version")
        err_b = max(err_b, err)
    print(f"check ({label}): pitch_candidates r {[tuple(a[0].shape) for a, _ in calls_a]} max |err| {err_a:.3e} "
          f"(tol {TOL_A}, valid equal); viterbi {[tuple(a[0].shape) for a, _ in calls_b]} max |err| {err_b} (exact)")
    return err_a, err_b


def multi_voice_phase(tmp: Path, card: str, b_s10_inputs, device="cuda") -> dict:
    """Phase 15 of the module docstring. Returns the ``kernels`` row of
    mask_ema, and the multi-voice launches, times and max |err| of A and B."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.audio import denoise as denoise_mod
    from prosody_control_french_tts_tpu_torch.audio.separate import MaskSeparator
    from prosody_control_french_tts_tpu_torch.core import batch_runner, profiling
    from prosody_control_french_tts_tpu_torch.ops import candidates, kernels, mask_ema, viterbi
    from prosody_control_french_tts_tpu_torch.ops.stft import stft
    from prosody_control_french_tts_tpu_torch.prosody.measure import measure_voice
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio, read_wav

    dev = torch.device(device)
    base = tmp / "multi_voice"
    texts, audio_s = {}, 0.0
    t0 = time.perf_counter()
    for name, seed, seconds in MULTI_VOICES:
        texts[name], s = build_brute_voice(base, name, seed, FULL_SEGMENTS, seconds=seconds)
        audio_s += s
    print(f"multi-voice set: {len(MULTI_VOICES)} brute recordings of {FULL_SEGMENTS} segments, {audio_s:.1f} s of audio, "
          f"made in {time.perf_counter() - t0:.1f} s; multiprocessing: true, denoise: mask")

    cold_timer = profiling.StepTimer()
    _, _, cold_s = drive_all_voices(base, texts, dev, "mask", cold_timer)
    warm_timer = profiling.StepTimer()
    reset_kernel_counts()
    profiling.reset_phases()
    with (Capture(batch_runner, "measure_all_voices") as cap_m, Capture(candidates, "topk_parabolic") as cap_a,
          Capture(viterbi, "viterbi_path") as cap_b):
        pipes, pre_pipes, warm_s = drive_all_voices(base, texts, dev, "mask", warm_timer)
    counts = kernel_counts()
    warm_phases = dict(profiling.PHASES)
    bdd_json = (base / "Out" / "results" / "bdd.json").read_text(encoding="utf-8")  # the break predictors' corpus (phase 20)
    print(f"multi-voice warm run launches: {json.dumps(counts)}")
    if counts["pitch_candidates"] != 2 or counts["viterbi"] != 2:
        raise SystemExit(f"multi-voice: kernels A and B must launch once per (T, rate) group (2), got {counts}")
    if counts["run_measure_device"] != 0:
        raise SystemExit(f"multi-voice: the per-voice measure pass ran {counts['run_measure_device']} times")
    if counts["frames"] or counts["chunk_cumsum"] or counts["mask_ema"]:
        raise SystemExit(f"multi-voice: no kernel C/D/E or mask_ema runs with denoise: mask, got {counts}")
    for name in texts:
        if len(pre_pipes[name].last_split) != FULL_SEGMENTS:
            raise SystemExit(f"multi-voice {name}: {len(pre_pipes[name].last_split)} segments")
        check_pipeline_artifacts(pipes[name], FULL_SEGMENTS, run_files=False)
    batched = cap_m.results[0]
    s_of = sorted(tuple(a[0].shape) for (a, _) in cap_b.calls)
    print(f"multi-voice viterbi inputs per group (S, F, K): {s_of}")
    # kernels A and B against their plain versions at each group's shapes
    err_a, err_b = check_a_b(cap_a.calls, cap_b.calls, "multi-voice, one call per (T, rate) group")

    # the batched rows against a per-voice measure_voice on the card
    def per_voice():
        return {n: measure_voice(p._segment_files(), p.textgrid_dir, p.raw_audio_dir, p.cfg.prosody,
                                 clean_word=p.pos_backend.remove_spurious_commas, device=dev) for n, p in pipes.items()}

    single = per_voice()
    errs = {n: rows_close(batched[n].rows, single[n].rows, TOL_BATCHED) for n in pipes}
    print(f"multi-voice batched vs per-voice measure_voice on the card: rows and syntagmes equal, max |diff| "
          f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})} points (tol {TOL_BATCHED})")
    alive = list(pipes.values())
    batched_trace = profile_measure(lambda: batch_runner.measure_all_voices(alive))
    single_trace = profile_measure(per_voice)

    # kernel B at S = 30 (the three-voice group) beside S = 10 (the measure voice)
    (d30, lf30, v30, fr30, vuv30, jump30), _ = max(cap_b.calls, key=lambda c: c[0][0].shape[0])
    (d10, lf10, v10, fr10, vuv10, jump10) = b_s10_inputs
    ms_b30 = cuda_ms(lambda: viterbi.viterbi_path(d30, lf30, v30, fr30, vuv30, jump30), reps=20)
    ms_b10 = cuda_ms(lambda: viterbi.viterbi_path(d10, lf10, v10, fr10, vuv10, jump10), reps=20)
    print(f"kernel viterbi at S = {d30.shape[0]} (the three-voice group, {tuple(d30.shape)}): {ms_b30:.4f} ms; at S = "
          f"{d10.shape[0]} (the measure voice, {tuple(d10.shape)}): {ms_b10:.4f} ms (CUDA events, same run); card={card}")

    # mask_ema on the mask of the 159.5 s recording (voice mv_a, seed 0: the pipeline phase's recording)
    brute = read_wav(base / "Data" / "voice" / "mv_a" / "brute" / "segment.wav").to_mono()
    x = torch.from_numpy(np.ascontiguousarray(brute.samples, np.float32)).to(dev)
    m = denoise_mod.gate_mask(stft(x, 1024, 256))
    mask_ema.reset_fixups()
    got = mask_ema.mask_ema(m)
    fixups = mask_ema.fixup_count()
    want = mask_ema.mask_ema_plain(m)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise SystemExit(f"mask_ema: {int((got != want).sum())} of {got.numel()} values differ from its plain version")
    err_ema = float((got - want).abs().max())
    ms_ema = graph_ms(lambda: mask_ema.mask_ema(m), reps=10)
    plain_ema = cuda_ms(lambda: mask_ema.mask_ema_plain(m), reps=1, warmup=0)
    bytes_ema = 2 * m.numel() * 4  # the mask read once, the result written once
    bound_ema = bytes_ema / HBM_BYTES_PER_S * 1e3
    # one chain a bin: 2 (T - 1) dependent steps of a multiply then an add
    alu_ns = alu_latency_ns(kernels.library())
    chain_ema = 2 * (m.shape[1] - 1) * 2 * alu_ns / 1e6
    print(f"kernel mask_ema: mask {tuple(m.shape)} of the {brute.duration_seconds:.1f} s recording, bit-equal to its plain "
          f"version; ms={ms_ema:.4f} (CUDA-graph replay) bound_ms={bound_ema:.5f} (bytes {bytes_ema}) chain_floor_ms="
          f"{chain_ema:.4f} (one chain a bin: 2 x ({m.shape[1]} - 1) steps x (mul + add) at {alu_ns:.2f} ns each, "
          f"measured on this card) fixups={fixups} (chunks recomputed, warm-up {mask_ema.WARMUP} frames) "
          f"plain_ms={plain_ema:.1f} card={card}")

    # the denoisers on the card against the CPU, on a 20 s excerpt, and their seconds per audio-second on the card
    exc = Audio(np.asarray(brute.samples[: int(EXCERPT_S * brute.rate)], np.float32), brute.rate)
    dn_card = denoise_mod.denoise(exc, device=dev).samples
    dn_cpu = denoise_mod.denoise(exc, device="cpu").samples
    dn_err = float(np.max(np.abs(dn_card - dn_cpu)))
    if dn_err > TOL_DENOISE * float(np.max(np.abs(exc.samples))):
        raise SystemExit(f"denoise: card vs CPU max |diff| {dn_err}")
    sep_card = MaskSeparator(device=dev)
    sp_card = sep_card.separate(exc).samples
    sp_cpu = MaskSeparator(device="cpu").separate(exc).samples
    sp_snr = si_snr_db(np.asarray(sp_card, np.float32), np.asarray(sp_cpu, np.float32))
    if sp_card.shape != sp_cpu.shape or sp_snr < MIN_SEPARATE_SI_SNR:
        raise SystemExit(f"MaskSeparator: card vs CPU SI-SNR {sp_snr} dB")
    t0 = time.perf_counter()
    denoise_mod.denoise(brute, device=dev)
    dn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sep_card.separate(brute)
    sp_s = time.perf_counter() - t0
    print(f"denoisers on a {EXCERPT_S:.0f} s excerpt, card vs CPU: denoise max |diff| {dn_err:.3e} (limit {TOL_DENOISE} of "
          f"the peak); MaskSeparator.separate SI-SNR {sp_snr:.1f} dB (limit {MIN_SEPARATE_SI_SNR}); on the "
          f"{brute.duration_seconds:.1f} s recording on the card: denoise {dn_s:.3f} s "
          f"({dn_s / brute.duration_seconds:.2e} s per audio-s), separate {sp_s:.3f} s ({sp_s / brute.duration_seconds:.2e} "
          f"s per audio-s); card={card}")

    # a 2-voice set in two groups with denoise: spectral, card against CPU
    small, small_texts = tmp / "multi_voice_small", {}
    for where in ("card", "cpu"):
        for name, seed, seconds in (("sv_a", 1, (3.0, 5.0)), ("sv_b", 5, (1.0, 2.0))):
            small_texts[name], _ = build_brute_voice(small / where, name, seed, 2, seconds=seconds)
    reset_kernel_counts()
    s_card, s_card_pre, _ = drive_all_voices(small / "card", small_texts, dev, "spectral")
    spectral_counts = kernel_counts()
    s_cpu, s_cpu_pre, _ = drive_all_voices(small / "cpu", small_texts, "cpu", "spectral")
    print(f"multi-voice spectral (2 voices, 2 groups) card run launches: {json.dumps(spectral_counts)}")
    if spectral_counts["mask_ema"] != len(small_texts) or spectral_counts["viterbi"] != 2:
        raise SystemExit(f"multi-voice spectral: mask_ema once per voice and B once per group, got {spectral_counts}")
    adj_err = 0.0
    for name in small_texts:
        a, b = s_card[name], s_cpu[name]
        if s_card_pre[name].last_split != s_cpu_pre[name].last_split:
            raise SystemExit(f"{name}: silence ranges card {s_card_pre[name].last_split} != CPU {s_cpu_pre[name].last_split}")
        for tg in sorted(b.textgrid_dir.glob("*.TextGrid")):
            if (a.textgrid_dir / tg.name).read_bytes() != tg.read_bytes():
                raise SystemExit(f"{name}: TextGrid {tg.name} differs between card and CPU")
        cols = lambda p: [(r["segment"], r["syntagme"], r["pause"]) for r in read_csv(p.bdd_syntagme_ssml_csv)]  # noqa: E731
        if cols(a) != cols(b):
            raise SystemExit(f"{name}: segment / syntagme / pause columns differ between card and CPU")
        adj_err = max([adj_err] + [max(abs(x.pitch_smooth - y.pitch_smooth), abs(x.rate_smooth - y.rate_smooth),
                                       abs(x.raw_volume - y.raw_volume))
                                   for x, y in zip(a.last_measure.rows, b.last_measure.rows)])
    if adj_err > 0.05:
        raise SystemExit(f"multi-voice spectral: card vs CPU adjustments differ by {adj_err} points")
    print(f"multi-voice spectral card vs CPU: ranges, TextGrids and segment/syntagme/pause columns equal; adjustments "
          f"max |diff| {adj_err:.2e} points")

    def split(timer):
        out: dict = {}
        for r in timer.records:
            out[r["step"]] = round(out.get(r["step"], 0.0) + r["seconds"], 4)
        return out

    print(f"multi-voice eight steps, {len(MULTI_VOICES)} voices, {audio_s:.1f} s of audio (warm): {warm_s:.3f} s, "
          f"{audio_s / warm_s:.1f} audio-s/s; cold {cold_s:.3f} s, {audio_s / cold_s:.1f} audio-s/s; card={card}")
    print("multi-voice steps warm (s, summed over the voices; the measure step once): " + json.dumps(split(warm_timer)))
    print("multi-voice steps cold (s): " + json.dumps(split(cold_timer)))
    print("multi-voice phases warm: " + json.dumps({k: round(v, 4) for k, v in sorted(warm_phases.items())}))
    print(f"multi-voice measure (warm, profiled): batched {batched_trace['wall_ms'] / 1e3:.3f} s, device busy "
          f"{batched_trace['device_busy_share']:.4f}; {len(pipes)} per-voice measure_voice calls {single_trace['wall_ms'] / 1e3:.3f} s, "
          f"device busy {single_trace['device_busy_share']:.4f}; card={card}")
    print("profile (batched measure): " + json.dumps(batched_trace))
    print("profile (per-voice measure): " + json.dumps(single_trace))
    row = dict(KERNEL_MASK_EMA, launches=spectral_counts["mask_ema"], max_abs_err=err_ema, ms=ms_ema, plain_ms=plain_ema,
               bound_ms=bound_ema, bound_by="bytes", library_ms=None, check="pass", chain_floor_ms=chain_ema,
               fixups=fixups, warmup_frames=mask_ema.WARMUP)
    return {"mask_ema": row, "launches": {"pitch_candidates": counts["pitch_candidates"], "viterbi": counts["viterbi"]},
            "viterbi_s30_ms": ms_b30, "viterbi_s10_ms": ms_b10, "err_a": err_a, "err_b": err_b, "bdd_json": bdd_json,
            "base": base}


# ---------------------------------------------------------------------------
# kernels C/D (frame gather) and E (chunk cumsum)
# ---------------------------------------------------------------------------


def check_equal(got, want, label: str) -> float:
    """Holds a kernel's output bit-equal to its plain version; returns the
    max |difference| as computed (0.0 when equal)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise SystemExit(f"{label}: kernel shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise SystemExit(f"{label}: kernel differs from its plain version ({(got != want).sum()} elements, max |diff| {err})")
    return err


def measure_shape_starts(T: int, B: int):
    """The Boersma frame starts ``ops.pitch`` uses at a padded length T (the
    measure voice's grid), clipped to the contract domain, for B rows."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import pitch

    g = pitch._geometry(T, 44100.0, pitch.PitchParams())
    cls = pitch._affine_frame_classes(g, T)
    i = torch.arange(g["n_frames"])
    s0 = torch.tensor(cls["starts0"])
    start = (s0[i % cls["q"]] + cls["stride"] * (i // cls["q"])).clamp(0, T - g["nsamp_window"])
    return start.to(torch.int32).expand(B, -1).contiguous(), torch.from_numpy(pitch._hanning(g["nsamp_window"]))


def kernels_cde_phase(seg_files, card: str, device="cuda") -> list:
    """Phase 5 of the module docstring. Returns the rows of C, D and E for the
    ``kernels`` line (launches filled in by the caller)."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.ops import chunk_cumsum, frames, pcm
    from prosody_control_french_tts_tpu_torch.prosody.measure import _load_padded

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    wrappers = ("extract_frames", "extract_frames_aligned", "frames_op")
    err = {fn: 0.0 for fn in wrappers + ("chunk_cumsum",)}

    def hann(W):
        return torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(W) / W)).astype(np.float32))

    # the JAX tests' shapes
    for shape_B, T, W, F, edges in ((None, 8192, 256, 37, False), (None, 50000, 880, 37, True), (2, 8192, 256, 37, False)):
        x = torch.from_numpy(rng.normal(size=(T,) if shape_B is None else (shape_B, T)).astype(np.float32))
        s = rng.integers(0, T - W + 1, size=(F,) if shape_B is None else (shape_B, F)).astype(np.int32)
        if edges:
            e = np.array([0, 1, 1023, 1024, 1025, 2047, 2048, T - W], np.int32)
            s[..., : e.size] = e
        s, w = torch.from_numpy(s), hann(W)
        want = frames.extract_frames_plain(x, s, w).to(dev)
        for fn in wrappers:
            e = check_equal(getattr(frames, fn)(x.to(dev), s.to(dev), w.to(dev), W), want, f"{fn} T {T} W {W} B {shape_B}")
            err[fn] = max(err[fn], e)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 4096)).astype(np.float32)).to(dev)
    e = check_equal(chunk_cumsum.chunk_cumsum(x), chunk_cumsum.chunk_cumsum_plain(x), "chunk_cumsum [16, 4096]")
    err["chunk_cumsum"] = max(err["chunk_cumsum"], e)

    # the measure voice's shape
    nat, _, _, _ = _load_padded(seg_files)
    xv = pcm.i16_to_f32(torch.from_numpy(nat)).to(dev)
    B, T = xv.shape
    starts, win = measure_shape_starts(T, B)
    starts, win = starts.to(dev), win.to(dev)
    F, W = starts.shape[1], win.shape[0]
    want = frames.extract_frames_plain(xv, starts, win)
    for fn in wrappers:
        err[fn] = max(err[fn], check_equal(getattr(frames, fn)(xv, starts, win, W), want, f"{fn} at the measure shape"))
    del want
    R = ((B + 7) // 8) * 8
    x2 = torch.zeros((R, T), dtype=torch.float32, device=dev)
    x2[:B] = xv * xv
    e = check_equal(chunk_cumsum.chunk_cumsum(x2), chunk_cumsum.chunk_cumsum_plain(x2), f"chunk_cumsum [{R}, {T}]")
    err["chunk_cumsum"] = max(err["chunk_cumsum"], e)
    print(f"check: frames kernel equal to plain at T 8192 / W 256 / F 37, T 50000 / W 880 (edge starts), B 2, and "
          f"[{B}, {T}] -> [{B}, {F}, {W}]; chunk_cumsum equal to plain at [16, 4096] and [{R}, {T}] (all exact)")

    idx = (starts.long()[..., None] + torch.arange(W, device=dev)).clamp(0, T - 1).reshape(B, -1)
    ms = {fn: graph_ms(lambda fn=fn: getattr(frames, fn)(xv, starts, win, W), reps=10) for fn in wrappers}
    plain_f = graph_ms(lambda: frames.extract_frames_plain(xv, starts, win), reps=3)
    lib_f = graph_ms(lambda: xv.gather(1, idx).view(B, F, W) * win, reps=5)
    del idx
    bytes_f = B * F * W * 4 + B * T * 4 + B * F * 4 + W * 4
    ops_f = B * F * W
    ms_e = graph_ms(lambda: chunk_cumsum.chunk_cumsum(x2), reps=20)
    plain_e = graph_ms(lambda: chunk_cumsum.chunk_cumsum_plain(x2), reps=3)
    lib_e = graph_ms(lambda: (torch.cumsum(x2.view(R, -1, 1024), -1) - x2.view(R, -1, 1024)).view(R, T), reps=10)
    bytes_e = 2 * R * T * 4
    ops_e = 11 * R * T  # ten ladder adds and one subtraction per element

    rows = []
    for spec, t, plain, lib, nbytes, nops, shape, max_err in (
        (KERNEL_C, ms["extract_frames"], plain_f, lib_f, bytes_f, ops_f, dict(B=B, T=T, F=F, W=W),
         max(err["extract_frames"], err["frames_op"])),
        (KERNEL_D, ms["extract_frames_aligned"], plain_f, lib_f, bytes_f, ops_f, dict(B=B, T=T, F=F, W=W),
         err["extract_frames_aligned"]),
        (KERNEL_E, ms_e, plain_e, lib_e, bytes_e, ops_e, dict(R=R, C=T), err["chunk_cumsum"]),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / PEAK_FLOPS["f32"] * 1e3
        rows.append(dict(spec, max_abs_err=max_err, ms=t, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=lib, check="pass", shape=shape))
        extra = (f"; the one-block-a-chunk design: {E_PREVIOUS_MS} ms (PERF.md, not measured here)"
                 if spec is KERNEL_E else "")
        print(f"kernel {spec['name']} ({json.dumps(shape)}): ms={t:.4f} bound_ms={max(t_bytes, t_ops):.5f} ({nbytes} bytes, {nops} ops) "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} card={card}{extra}")
    print(f"kernel frames via frames_op: ms={ms['frames_op']:.4f}; card={card}")
    return rows


# ---------------------------------------------------------------------------
# the LLM serving path
# ---------------------------------------------------------------------------

FRENCH = [
    "Le portrait du compositeur est accroché au mur du salon.",
    "Elle marche lentement, puis elle s'arrête devant la porte.",
    "Bonjour, comment allez-vous aujourd'hui ?",
    "Le train de nuit arrive à Paris vers six heures du matin.",
    "Nous avons mangé du pain, du fromage et des pommes.",
]


def random_fused_tree(cfg, seed: int):
    """The training-layout model made on the card from the seed, lora_b given
    values so the fold does work, fused to the bfloat16 serving tree; the
    model is freed before returning."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    model = llm.DecoderLM(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, par in model.named_parameters():
            if name.endswith("lora_b"):
                par.normal_(0.0, 0.02, generator=gen)
    train_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    fp = llm.fuse_decode_params(model, cfg)
    del model
    torch.cuda.empty_cache()
    return fp, train_bytes


def serve(fp, cfg, prompt, new: int, eos_id=None):
    """One greedy_generate_fused call → (tokens, wall seconds to the end of
    the device's work)."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = llm.greedy_generate_fused(fp, cfg, prompt, new, eos_id=eos_id, device="cuda")
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def check_served_tokens(fp, cfg, prompt, toks, new: int) -> None:
    """Token ids in [0, vocab), the prompt copied through, and the first
    generated token equal to the argmax of a separate last-position prefill."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    B, P = prompt.shape
    if toks.shape != (B, P + new) or toks.dtype != torch.int32 or not toks.is_cuda:
        raise SystemExit(f"served tokens: shape {tuple(toks.shape)} dtype {toks.dtype} on {toks.device}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise SystemExit("served tokens outside [0, vocab)")
    pr = torch.as_tensor(prompt, device="cuda")
    if not torch.equal(toks[:, :P], pr.to(torch.int32)):
        raise SystemExit("the prompt was not copied through")
    caches = llm.init_kv_caches_fused(cfg, B, P + new, fp["embed"].dtype, "cuda")
    positions = torch.arange(P, device="cuda").expand(B, P)
    logits, _ = llm._fused_forward(fp, cfg, pr.to(torch.int32), positions, caches, 0, last_only=True)
    if not torch.isfinite(logits).all():
        raise SystemExit("prefill logits are not finite")
    if not torch.equal(logits[:, -1].argmax(-1).to(torch.int32), toks[:, P]):
        raise SystemExit("first generated token differs from the separate prefill's argmax")


def profile_decode_steps(fp, cfg, tokens, steps: int = 8) -> dict:
    """The last ``steps`` decode steps of a finished call, replayed teacher-
    forced under torch.profiler: per-step wall and device time split into
    matrix products, kernel F, other kernels (elementwise, reductions,
    indexing), copies, and the host gap (wall − device)."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    B, S = tokens.shape
    start = S - 1 - steps
    caches = llm.init_kv_caches_fused(cfg, B, S, fp["embed"].dtype, "cuda")
    llm._fused_forward(fp, cfg, tokens[:, :start], torch.arange(start, device="cuda").expand(B, start), caches, 0, last_only=True)

    def run():
        for pos in range(start, start + steps):
            positions = torch.full((B, 1), pos, device="cuda")
            logits, _ = llm._fused_forward(fp, cfg, tokens[:, pos : pos + 1], positions, caches, pos)
            logits[:, -1].argmax(-1)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, by_name = profile_device(run)
    split = {"matmul": 0.0, "kernel_F": 0.0, "other_kernels": 0.0, "copies": 0.0}
    f_launches = 0
    for name, (ms, n) in by_name.items():
        low = name.lower()
        if "decode_attn" in low:
            split["kernel_F"] += ms
            f_launches += n
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "cublas", "xmma", "nvjet", "splitk", "wgmma")):
            split["matmul"] += ms
        elif "memcpy" in low or "memset" in low:
            split["copies"] += ms
        else:
            split["other_kernels"] += ms
    device_ms = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "steps": steps,
        "step_wall_ms": plain_wall_ms / steps,
        "step_wall_ms_profiled": wall_ms / steps,
        "step_device_ms": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "host_gap_ms_per_step_profiled": (wall_ms - device_ms) / steps,
        "per_step_ms": {k: v / steps for k, v in split.items()},
        "kernel_F_share_of_device": split["kernel_F"] / device_ms if device_ms else None,
        "kernel_F_ms_per_launch": split["kernel_F"] / f_launches if f_launches else None,
        "kernels_per_step": sum(n for _, n in by_name.values()) / steps,
        "top_device_ms": [[k, round(t, 4), n] for k, (t, n) in top],
    }


def explain_mismatches(ref_tree, cfg, got, ref) -> int:
    """Rows where two greedy runs differ: at the first differing position
    the reference tree's logits of the two candidate tokens must be a near
    tie (within 1e-4 of the largest |logit|), else the runs truly disagree.
    Returns the number of such rows."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    rows = (got != ref).any(dim=1).nonzero()[:, 0].tolist()
    for r in rows:
        j = int((got[r] != ref[r]).nonzero()[0, 0])
        caches = llm.init_kv_caches_fused(cfg, 1, j, ref_tree["embed"].dtype, "cuda")
        logits, _ = llm._fused_forward(ref_tree, cfg, ref[r : r + 1, :j], torch.arange(j, device="cuda")[None], caches, 0, last_only=True)
        lg = logits[0, -1]
        gap = float((lg[int(got[r, j])] - lg[int(ref[r, j])]).abs())
        if gap > 1e-4 * float(lg.abs().max()):
            raise SystemExit(f"int8b vs dequantized: row {r} differs at {j} with a logit gap of {gap}")
    return len(rows)


def check_kernel_f(call, label: str) -> float:
    """Kernel F against its plain version on a captured call's tensors, at
    the call's own (late) pos and at pos 0, in the working dtype and upcast
    to float32; and rows beyond pos set to ±1e4 change nothing. Returns the
    working-dtype max |err|."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import decode_attn

    (q, kc, vc, pos, kv), _ = call
    worst = {}
    for name, tol, cast in (("bf16", TOL_F_BF16, lambda t: t), ("f32", TOL_F_F32, lambda t: t.float())):
        qq, kk, vv = cast(q), cast(kc), cast(vc)
        worst[name] = 0.0
        for p_ in (pos, 0):
            got = decode_attn.decode_attention(qq, kk, vv, p_, kv).float()
            torch.cuda.synchronize()
            want = decode_attn.decode_attention_plain(qq, kk, vv, p_, kv).float()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool((diff > tol + tol * want.abs()).any()):
                raise SystemExit(f"kernel F ({label}, {name}, pos {p_}): max |err| {float(diff.max())} beyond {tol}")
            worst[name] = max(worst[name], float(diff.max()))
    half = pos // 2
    base = decode_attn.decode_attention(q, kc, vc, half, kv)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, half + 1 :] = 1e4
    vc2[:, half + 1 :] = -1e4
    if not torch.equal(base, decode_attn.decode_attention(q, kc2, vc2, half, kv)):
        raise SystemExit(f"kernel F ({label}): rows beyond pos changed the result")
    if not torch.equal(decode_attn.decode_attention(q, kc, vc, pos, kv), decode_attn.decode_attention(q, kc, vc, pos, kv)):
        raise SystemExit(f"kernel F ({label}): two calls on the same tensors differ")
    C = decode_attn.split_plan(q.shape[0], kv, kc.shape[1], torch_sm_count())
    print(f"check: decode_attn {label} q {tuple(q.shape)} {str(q.dtype)[6:]} caches {tuple(kc.shape)} pos {pos} and 0 "
          f"({C} blocks a cluster): max |err| {worst['bf16']:.3e} (tol {TOL_F_BF16}), upcast to float32 {worst['f32']:.3e} "
          f"(tol {TOL_F_F32}); future rows ignored; two calls bit-equal")
    return worst["bf16"]


def time_kernel_f(call) -> dict:
    """Device times (torch.profiler, see device_ms) of kernel F, its plain
    version and one scaled_dot_product_attention call on the unpacked view
    (rows 0..pos), on a captured call's tensors. The decode loop streams the
    whole weight tree between two launches, so the caches are cold in L2
    there: the timed loop rotates over enough copies of the caches to exceed
    the 50 MB L2. ``events_ms`` is the same loop between two CUDA events: wall
    time per call, host launch overhead included."""
    import torch
    import torch.nn.functional as F

    from prosody_control_french_tts_tpu_torch.ops import decode_attn

    (q, kc, vc, pos, kv), _ = call
    B, H, hd = q.shape
    n = pos + 1
    item = q.element_size()
    nbytes = 2 * B * n * kv * hd * item + 2 * B * H * hd * item
    flops = 4 * B * H * n * hd
    copies = max(2, int(120e6 // (2 * kc.numel() * item)) + 1)
    ks = [kc.clone() for _ in range(copies)]
    vs = [vc.clone() for _ in range(copies)]
    views = [(k[:, :n].view(B, n, kv, hd).transpose(1, 2), v[:, :n].view(B, n, kv, hd).transpose(1, 2)) for k, v in zip(ks, vs)]
    q4 = q[:, :, None, :]
    try:
        F.scaled_dot_product_attention(q4, *views[0], enable_gqa=True)
        sdpa = lambda k4, v4: F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)  # noqa: E731
    except TypeError:  # a PyTorch without enable_gqa: repeat the KV heads outside the timed call
        views = [(k4.repeat_interleave(H // kv, dim=1), v4.repeat_interleave(H // kv, dim=1)) for k4, v4 in views]
        sdpa = lambda k4, v4: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
    turn = [0]

    def rotating(fn, args):
        def run():
            turn[0] += 1
            return fn(*args[turn[0] % copies])

        return run

    pairs = list(zip(ks, vs))
    kernel = rotating(lambda k, v: decode_attn.decode_attention(q, k, v, pos, kv), pairs)
    ms = device_ms(kernel, reps=100)
    events_ms = cuda_ms(kernel, reps=200, warmup=5)
    plain_ms = device_ms(rotating(lambda k, v: decode_attn.decode_attention_plain(q, k, v, pos, kv), pairs), reps=20)
    lib_ms = device_ms(rotating(sdpa, views), reps=100)
    hot_ms = device_ms(lambda: decode_attn.decode_attention(q, kc, vc, pos, kv), reps=100)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bf16" if item == 2 else "f32"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, hot_l2_ms=hot_ms, events_ms=events_ms, bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=dict(B=B, H=H, kv_heads=kv, hd=hd, S=kc.shape[1], pos=pos, dtype=str(q.dtype)[6:],
                           blocks_per_cluster=decode_attn.split_plan(B, kv, kc.shape[1], torch_sm_count())))


def llm_phases(args, card: str) -> dict:
    """Phases 8–10 of the module docstring, and kernel F's check and timing
    on the tensors those paths gave it. Returns kernel F's row."""
    import dataclasses

    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.models import cascade, llm, quant
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer
    from prosody_control_french_tts_tpu_torch.ops import decode_attn

    rng = np.random.default_rng(args.seed)

    # -- 8. LLM serving at the full width of qwen25_7b ----------------------
    cfg = llm.LLMConfig.qwen25_7b()  # full width and full depth
    B, P, NEW = 16, 64, 128
    t0 = time.perf_counter()
    fp, train_bytes = random_fused_tree(cfg, args.seed)
    torch.cuda.synchronize()
    print(f"llm 7B: dim {cfg.dim}, {cfg.layers} layers, {cfg.heads} heads, {cfg.kv_heads} KV heads, hd {cfg.head_dim}, ffn {cfg.ffn}, "
          f"vocab {cfg.vocab_size}; float32 training tree {train_bytes / 1e9:.2f} GB -> fused bf16 tree {quant.quantized_bytes(fp) / 1e9:.2f} GB, "
          f"built and fused in {time.perf_counter() - t0:.1f} s")
    prompt = rng.integers(1, cfg.vocab_size, size=(B, P)).astype(np.int32)
    decode_attn.launches = 0
    with Capture(decode_attn, "decode_attention", keep=cfg.layers) as cap_7b:
        toks, cold_s = serve(fp, cfg, prompt, NEW)
    launches_7b = decode_attn.launches
    want_launches = cfg.layers * (NEW - 1)
    print(f"llm 7B main path launches: {json.dumps({'decode_attn': launches_7b})} (expected {want_launches})")
    if launches_7b != want_launches:
        raise SystemExit(f"kernel F launched {launches_7b} times on the 7B run, expected {want_launches}")
    check_served_tokens(fp, cfg, prompt, toks, NEW)
    toks_w, warm_s = serve(fp, cfg, prompt, NEW)
    if not torch.equal(toks, toks_w):
        raise SystemExit("7B: the warm run's tokens differ from the cold run's")
    _, prefill_s = serve(fp, cfg, prompt, 1)
    _, sync_s = serve(fp, cfg, prompt, NEW, eos_id=cfg.vocab_size)  # an id no row emits: the stop test runs, never fires
    step_ms = (warm_s - prefill_s) / (NEW - 1) * 1e3
    split_7b = profile_decode_steps(fp, cfg, toks)
    print(f"llm 7B serving (bf16, B {B}, P {P}, new {NEW}): warm {warm_s:.3f} s, {B * NEW / warm_s:.1f} tokens/s, "
          f"prefill {prefill_s * 1e3:.1f} ms, {step_ms:.3f} ms per decode step; cold {cold_s:.3f} s, {B * NEW / cold_s:.1f} tokens/s; "
          f"with the per-step stop test {sync_s:.3f} s, {B * NEW / sync_s:.1f} tokens/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; card={card}")
    print("llm 7B decode step split: " + json.dumps(split_7b))
    call_7b = cap_7b.calls[0]
    err_7b = check_kernel_f(call_7b, "7B geometry")
    time_7b = time_kernel_f(call_7b)
    del fp, cap_7b, call_7b, toks, toks_w
    torch.cuda.empty_cache()

    # -- 9. the JAX bench's geometry, bf16 and int8b -------------------------
    bcfg = llm.LLMConfig(vocab_size=32768, dim=896, layers=12, heads=14, kv_heads=2, ffn=2432, max_len=512, lora_rank=8)
    B, P, NEW = 64, 64, 256
    fp, _ = random_fused_tree(bcfg, args.seed + 2)
    prompt = rng.integers(1, bcfg.vocab_size, size=(B, P)).astype(np.int32)
    n0 = decode_attn.launches
    with Capture(decode_attn, "decode_attention", keep=bcfg.layers) as cap_b:
        toks, cold_s = serve(fp, bcfg, prompt, NEW)
    if decode_attn.launches - n0 != bcfg.layers * (NEW - 1):
        raise SystemExit(f"bench geometry: kernel F launched {decode_attn.launches - n0} times, expected {bcfg.layers * (NEW - 1)}")
    check_served_tokens(fp, bcfg, prompt, toks, NEW)
    _, warm_s = serve(fp, bcfg, prompt, NEW)
    _, prefill_s = serve(fp, bcfg, prompt, 1)
    split_b = profile_decode_steps(fp, bcfg, toks)
    print(f"llm bench geometry (dim {bcfg.dim}, {bcfg.layers} layers, hd {bcfg.head_dim}; bf16, B {B}, P {P}, new {NEW}): "
          f"warm {warm_s:.3f} s, {B * NEW / warm_s:.1f} tokens/s, {(warm_s - prefill_s) / (NEW - 1) * 1e3:.3f} ms per decode step; "
          f"cold {cold_s:.3f} s; card={card}")
    print("llm bench geometry decode step split: " + json.dumps(split_b))
    call_b = cap_b.calls[0]
    err_b = check_kernel_f(call_b, "bench geometry")
    time_b = time_kernel_f(call_b)

    t0 = time.perf_counter()
    fq = llm.quantize_fused_decode_params(fp, mode="int8b")
    quant_s = time.perf_counter() - t0
    toks_q, _ = serve(fq, bcfg, prompt, NEW)
    check_served_tokens(fq, bcfg, prompt, toks_q, NEW)
    _, warm_q = serve(fq, bcfg, prompt, NEW)
    # the int8b tree against the same tree dequantized, in float32 (in
    # bfloat16 the dense path rounds every dequantized weight, the block
    # partial sums do not, so tokens may part there by design)
    def as_f32(w, dequantize):
        if isinstance(w, dict):
            if not dequantize:
                return w
            return quant.dequant_int8_block(w["codes"], w["scale"], torch.float32, w["codes"].shape[0] // w["scale"].shape[0])
        return w.float()

    trees = [
        {**{k: as_f32(v, deq) for k, v in fq.items() if k != "layers"}, "layers": [{k: as_f32(v, deq) for k, v in lw.items()} for lw in fq["layers"]]}
        for deq in (False, True)
    ]
    fcfg = dataclasses.replace(bcfg, dtype=torch.float32)
    got, _ = serve(trees[0], fcfg, prompt, NEW)
    ref, _ = serve(trees[1], fcfg, prompt, NEW)
    near_ties = explain_mismatches(trees[1], fcfg, got, ref)
    print(f"llm bench geometry int8b: {quant.quantized_bytes(fq) / 1e9:.3f} GB tree (bf16 {quant.quantized_bytes(fp) / 1e9:.3f} GB), "
          f"quantized on the host in {quant_s:.1f} s; warm {warm_q:.3f} s, {B * NEW / warm_q:.1f} tokens/s; in float32 the int8b tokens equal "
          f"the dequantized tree's in {B - near_ties} of {B} rows ({near_ties} rows part at a logit near-tie); card={card}")
    del fp, fq, trees, cap_b, call_b
    torch.cuda.empty_cache()

    # -- 10. the cascade with tiny models, card against CPU -------------------
    tok = WordPieceTokenizer.train(FRENCH + [cascade.format_example(cascade.TASK_A, FRENCH[0], FRENCH[0] + " <break/>")], vocab_size=250, min_freq=1)
    ccfg = llm.LLMConfig(vocab_size=len(tok), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=256, dtype=torch.float32)
    on_cpu = [llm.DecoderLM(ccfg, device="cpu", seed=args.seed + s) for s in (10, 11)]
    on_card = [llm.DecoderLM(ccfg, device="cuda", seed=0) for _ in on_cpu]
    for c, g in zip(on_cpu, on_card):
        g.load_state_dict(c.state_dict())
        if not all(t.is_cuda for t in g.state_dict().values()):
            raise SystemExit("cascade: a model tensor is not on the card")
    t0 = time.perf_counter()
    text_card = cascade.run_cascade(*on_card, tok, FRENCH[1], device="cuda")
    card_s = time.perf_counter() - t0
    text_cpu = cascade.run_cascade(*on_cpu, tok, FRENCH[1], device="cpu")
    if not isinstance(text_card, str) or not text_card or text_card != text_cpu:
        raise SystemExit(f"cascade: card {text_card!r} != CPU {text_cpu!r}")
    print(f"cascade: two tiny float32 stages (vocab {len(tok)}), 2 x 128 new tokens on the card in {card_s:.2f} s; "
          f"the card's string ({len(text_card)} chars) equals the CPU's")

    row = dict(KERNEL_F, launches=launches_7b, max_abs_err=err_7b, **{k: time_7b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
               check="pass", hot_l2_ms=time_7b["hot_l2_ms"], events_ms=time_7b["events_ms"], shape=time_7b["shape"],
               bench_geometry=dict(time_b, max_abs_err=err_b, launches=bcfg.layers * (NEW - 1)))
    for label, t, n, err, prev in (("7B geometry", time_7b, launches_7b, err_7b, F_PREVIOUS_MS[0]),
                                   ("bench geometry", time_b, bcfg.layers * (NEW - 1), err_b, F_PREVIOUS_MS[1])):
        print(f"kernel decode_attn ({label} {json.dumps(t['shape'])}): ms={t['ms']:.4f} (L2-hot {t['hot_l2_ms']:.4f}, between events with host overhead {t['events_ms']:.4f}) launches={n} "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: {t['bytes']} bytes, {t['flops']} flops) plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} max_abs_err={err:.3e} card={card}; the one-block-per-head design: {prev} ms (PERF.md, not measured here)")
    return row


# ---------------------------------------------------------------------------
# the LLM training path
# ---------------------------------------------------------------------------


def train_counts() -> dict:
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, fused_ce, vmem_attn

    return {"vmem_attn_fwd": vmem_attn.launches, "vmem_attn_bwd": vmem_attn.launches_bwd,
            "flash_attn_fwd": flash_attention.launches, "flash_attn_bwd": flash_attention.launches_bwd,
            "fused_ce_fwd": fused_ce.launches, "fused_ce_bwd": fused_ce.launches_bwd}


def reset_train_counts() -> None:
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, fused_ce, vmem_attn

    vmem_attn.launches = vmem_attn.launches_bwd = 0
    flash_attention.launches = flash_attention.launches_bwd = 0
    fused_ce.launches = fused_ce.launches_bwd = 0


# attn_impl -> (module under ops, wrapper the model calls, forward and
# backward count keys) of the attention kernel the training step runs
ATTN_WRAPPERS = {"vmem": ("vmem_attn", "causal_attention_vmem", "vmem_attn_fwd", "vmem_attn_bwd"),
                 "flash": ("flash_attention", "flash_attention_gqa", "flash_attn_fwd", "flash_attn_bwd")}


def expected_train_counts(attn_impl: str, layers: int, steps: int) -> dict:
    """Every kernel count of the training path after ``steps`` steps: the
    attention of ``attn_impl`` layers x steps each way, H once a step each
    way, the other attention kernel never."""
    *_, fwd, bwd = ATTN_WRAPPERS[attn_impl]
    want = {k: 0 for k in train_counts()}
    want.update({fwd: layers * steps, bwd: layers * steps, "fused_ce_fwd": steps, "fused_ce_bwd": steps})
    return want


def set_attn_impl(model, attn_impl: str) -> None:
    """Switch a built DecoderLM's attention path: every module that reads the
    config gets a copy with ``attn_impl`` replaced."""
    import dataclasses

    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = dataclasses.replace(m.cfg, attn_impl=attn_impl)


def profile_train_steps(run, steps: int) -> dict:
    """``run()`` (``steps`` optimizer steps) under torch.profiler: per-step
    wall and device time split into matrix products (cuBLAS), the attention
    kernels (G or the flash attention) and H, forward and backward, other
    kernels and copies."""
    wall_ms, by_name = profile_device(run)
    split = {"matmul": 0.0, "G_fwd": 0.0, "G_bwd": 0.0, "FA_fwd": 0.0, "FA_bwd": 0.0, "H_fwd": 0.0, "H_bwd": 0.0,
             "other_kernels": 0.0, "copies": 0.0}
    fa_bwd = {"dq": 0.0, "dkv": 0.0, "group_sum": 0.0}  # FA_bwd by kernel
    for name, (ms, _) in by_name.items():
        low = name.lower()
        for part, key in (("dq", "flash_dq"), ("dkv", "flash_dkv_bf16"), ("dkv", "flash_dkv_f32"), ("group_sum", "flash_dkv_group_sum")):
            if key in low:
                fa_bwd[part] += ms
        if "vmem_attn_fwd" in low:
            split["G_fwd"] += ms
        elif "vmem_attn_bwd" in low:
            split["G_bwd"] += ms
        elif "flash_fwd" in low:
            split["FA_fwd"] += ms
        elif "flash_dq" in low or "flash_dkv" in low:
            split["FA_bwd"] += ms
        elif "fused_ce_fwd" in low or "fused_ce_combine" in low:
            split["H_fwd"] += ms
        elif "fused_ce_coef" in low or "fused_ce_dh" in low:
            split["H_bwd"] += ms
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "cublas", "xmma", "nvjet", "splitk", "wgmma")):
            split["matmul"] += ms
        elif "memcpy" in low or "memset" in low:
            split["copies"] += ms
        else:
            split["other_kernels"] += ms
    device_ms = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "steps": steps,
        "step_wall_ms_profiled": wall_ms / steps,
        "step_device_ms": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "per_step_ms": {k: v / steps for k, v in split.items()},
        "fa_bwd_per_step_ms": {k: v / steps for k, v in fa_bwd.items()},
        # the split informs, it checks nothing: a profile without device records gives no shares
        "share_of_device": {k: v / device_ms for k, v in split.items()} if device_ms else None,
        "kernels_per_step": sum(n for _, n in by_name.values()) / steps,
        "top_device_ms": [[k, round(t, 4), n] for k, (t, n) in top],
    }


def frozen_fingerprint(model) -> dict:
    """Float64 sums of a few frozen leaves (any change shows)."""
    import torch

    leaves = {"embed": model.embed.embedding, "layer0.q": model.layers[0].attn.q.kernel,
              "last.down": model.layers[-1].mlp.down.kernel, "lm_head": model.lm_head.kernel, "ln_f": model.ln_f.scale}
    return {k: float(v.detach().sum(dtype=torch.float64)) for k, v in leaves.items()}


def run_trainer(label: str, cfg, B: int, L: int, seed: int, card: str, scan: bool, dot_peak: bool = False):
    """init_train + make_train_step on the card, one warm step then
    TRAIN_STEPS more on a repeated batch; the checks of phases 11 and 14: the
    attention kernel of ``cfg.attn_impl`` counted layers x steps each way, the
    other attention kernel and the dot path never, H once a step each way.
    With ``dot_peak``, one more step through the dot path (the [B, H, L, L]
    scores in device memory) on the same model, for its peak memory. Returns
    (launch counts of all the steps, captured tensors for the kernel checks,
    times, a function that profiles one more step and prints its split).
    The split is taken last of all: once the trainers have run, torch.profiler
    has lost kernel records in this process, and nothing after the split
    depends on it."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm, training
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, fused_ce

    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()  # an earlier trainer kept alive for its step split
    t0 = time.perf_counter()
    model, tx, state = training.init_train(cfg, seed=seed, lr=1e-3, frozen_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in model.parameters())
    if any(p.requires_grad != name.endswith(("lora_a", "lora_b")) for name, p in model.named_parameters()):
        raise SystemExit(f"{label}: requires_grad is not on the LoRA leaves only")
    if model.lm_head.kernel.dtype != torch.bfloat16 or model.layers[0].attn.q.lora_a.dtype != torch.float32:
        raise SystemExit(f"{label}: frozen_dtype did not downcast the base only")
    n_steps = 1 + TRAIN_STEPS
    step = training.make_train_step(model, tx, trainable=state.mask, loss_impl="auto", scan_steps=TRAIN_STEPS if scan else None)
    if step.loss_impl != "fused":
        raise SystemExit(f"{label}: loss_impl='auto' resolved to {step.loss_impl!r}, expected 'fused'")
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, L)).astype(np.int32)).cuda()
    mask = torch.ones((B, L), dtype=torch.float32, device="cuda")
    single = training.make_train_step(model, tx, trainable=state.mask, loss_impl="auto") if scan else step
    before = frozen_fingerprint(model)
    adapters = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    print(f"train {label}: dim {cfg.dim}, {cfg.layers} layers, {cfg.heads} heads, {cfg.kv_heads} KV heads, hd {cfg.head_dim}, ffn {cfg.ffn}, "
          f"vocab {cfg.vocab_size}, rank {cfg.lora_rank}; {n_all / 1e9:.3f} G parameters, {n_train / 1e6:.2f} M trainable; B {B}, L {L}; "
          f"built in {build_s:.1f} s, {(torch.cuda.memory_allocated() - base_bytes) / 1e9:.2f} GB of weights; cuts: none")

    reset_train_counts()
    cap_dot = Capture(llm, "_masked_attention", keep=1).__enter__()  # the dot path, counted over every step
    cap_rep = Capture(flash_attention, "repeat_kv", keep=1).__enter__()  # the K/V repeat: the kernels read GQA in place
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(single(ids, mask))]  # the warm step (kernels' first launches, cuBLAS plans)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    attn_module, attn_wrapper, *_ = ATTN_WRAPPERS[cfg.attn_impl]
    attn_module = importlib.import_module(f"prosody_control_french_tts_tpu_torch.ops.{attn_module}")
    with GradCapture(attn_module, attn_wrapper, keep=1) as cap_g, GradCapture(fused_ce, "linear_ce_rows", keep=1) as cap_h:
        t0 = time.perf_counter()
        if scan:
            losses += step(ids.expand(TRAIN_STEPS, B, L), mask).tolist()
        else:
            losses += [float(step(ids, mask)) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    cap_dot.__exit__()
    cap_rep.__exit__()
    counts = dict(train_counts(), dot_attention=cap_dot.count, repeat_kv=cap_rep.count)
    want = dict(expected_train_counts(cfg.attn_impl, cfg.layers, n_steps), dot_attention=0, repeat_kv=0)
    print(f"train {label} main path launches: {json.dumps(counts)} (expected {json.dumps(want)})")
    if counts != want:
        raise SystemExit(f"train {label}: launch counts {counts}, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"train {label}: losses {losses} are not finite and falling")
    if frozen_fingerprint(model) != before:
        raise SystemExit(f"train {label}: a frozen leaf changed")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p.detach(), adapters[n])]
    if still:
        raise SystemExit(f"train {label}: {len(still)} adapter leaves did not move, e.g. {still[0]}")
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    print(f"train {label} ({'scan_steps=%d' % TRAIN_STEPS if scan else 'single steps'}, bf16 frozen base, {cfg.attn_impl} + fused_qkv + fused loss): "
          f"losses {[round(x, 4) for x in losses]}; warm {warm_ms:.1f} ms per optimizer step, {B * L / warm_ms * 1e3:.1f} tokens/s; "
          f"cold first step {cold_ms:.1f} ms; peak device memory {peak_gb:.2f} GB; card={card}")
    dot_peak_gb = None
    if dot_peak:
        set_attn_impl(model, "dot")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with Capture(llm, "_masked_attention", keep=1) as cap_dot:
            t0 = time.perf_counter()
            dot_loss = float(single(ids, mask))
            dot_ms = (time.perf_counter() - t0) * 1e3
        dot_peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
        set_attn_impl(model, cfg.attn_impl)
        if cap_dot.count != cfg.layers or not np.isfinite(dot_loss):
            raise SystemExit(f"train {label}: the dot step took the dot path {cap_dot.count} times, loss {dot_loss}")
        print(f"train {label} peak device memory: {cfg.attn_impl} {peak_gb:.2f} GB, dot path {dot_peak_gb:.2f} GB for one step at the same shape "
              f"({dot_ms:.1f} ms, loss {dot_loss:.4f}); card={card}")
    (q, k, v, *_), dout = cap_g.calls[0]
    (h, w, tgt), g = cap_h.calls[0]
    captured = dict(q=q.detach().contiguous(), k=k.detach().contiguous(), v=v.detach().contiguous(), dout=dout.contiguous(),
                    h=h.detach().contiguous(), w=w.detach(), tgt=tgt.detach().to(torch.int32).contiguous(), g=g.float().contiguous())
    stats = dict(warm_ms=warm_ms, tokens_per_s=B * L / warm_ms * 1e3, cold_ms=cold_ms, peak_gb=peak_gb, dot_peak_gb=dot_peak_gb, losses=losses)

    def split_step():
        # one more step under torch.profiler; the closure keeps the trainer alive until then
        print(f"train {label} step split: " + json.dumps(profile_train_steps(lambda: single(ids, mask), 1)))

    return counts, captured, stats, split_step


def parity_on_card(seed: int, attn_impl: str = "vmem", L: int = 128) -> None:
    """Phases 12 and 14: 4 steps at a small float32 shape, (attn_impl,
    "fused") on the card against ("dot", "dense") on the card and on the CPU,
    from the same initial weights. The shape is that of the JAX package's
    train-step parity test with dim 256 instead of 128, so that the head dim
    is 64, one of the two that the kernels are instantiated for; L 128 for G,
    256 (two tiles of the upstream op) for the flash attention."""
    import dataclasses

    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm, training

    cfg = llm.LLMConfig(vocab_size=1024, dim=256, layers=2, heads=4, kv_heads=2, ffn=256, max_len=L, lora_rank=4, dtype=torch.float32)
    ids = np.random.default_rng(seed).integers(1, cfg.vocab_size, (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.float32)
    init = llm.DecoderLM(cfg, device="cpu", seed=seed).state_dict()
    curves = {}
    reset_train_counts()
    for impl, loss_impl, device in ((attn_impl, "fused", "cuda"), ("dot", "dense", "cuda"), ("dot", "dense", "cpu")):
        model, tx, state = training.init_train(dataclasses.replace(cfg, attn_impl=impl), lr=1e-3, device=device)
        model.load_state_dict(init)
        step = training.make_train_step(model, tx, trainable=state.mask, loss_impl=loss_impl)
        curves[(impl, loss_impl, device)] = [float(step(ids, mask)) for _ in range(4)]
    counts = train_counts()
    if counts != expected_train_counts(attn_impl, cfg.layers, 4):
        raise SystemExit(f"parity ({attn_impl}): launch counts {counts}")
    got = curves[(attn_impl, "fused", "cuda")]
    worst = 0.0
    for key in (("dot", "dense", "cuda"), ("dot", "dense", "cpu")):
        for a, b in zip(got, curves[key]):
            worst = max(worst, abs(a - b) / abs(b))
    print(f"parity: loss curves over 4 float32 steps at L {L}: ({attn_impl}, fused) on the card {[round(x, 6) for x in got]}, (dot, dense) on the card "
          f"{[round(x, 6) for x in curves[('dot', 'dense', 'cuda')]]}, on the CPU {[round(x, 6) for x in curves[('dot', 'dense', 'cpu')]]}; "
          f"max relative difference {worst:.3e} (tol {TOL_PARITY})")
    if worst > TOL_PARITY or not got[-1] < got[0]:
        raise SystemExit(f"parity ({attn_impl}): loss curves differ by {worst} relative")


def attn_grads(fn, q, k, v, dout, scale):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, scale)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def g_measure(got, want, ref, grad: bool) -> float:
    """Kernel G's measure: the forward's max |err|, a gradient's max |err|
    over the plain gradient's largest element (``ref`` unused)."""
    d = float((got.float() - want.float()).abs().max())
    return d / max(float(want.float().abs().max()), 1e-30) if grad else d


def fa_measure(got, want, ref, grad: bool) -> float:
    """The flash attention's bfloat16 measure on the model's layout
    [B, L, heads, hd]. Forward: the largest row error over its scale,
    |got - plain| / (|plain| + FA_FLOOR * the largest |plain|), |.| the 2-norm
    of a row of hd values. Gradients: the largest over (b, head) of
    |got - ref| / |plain - ref|, ``ref`` the plain version in float32 on the
    upcast inputs, |.| the 2-norm over L x hd (heads are query heads for dq,
    KV heads for dk and dv)."""
    if grad:
        d = (got.float() - ref).transpose(1, 2).flatten(2).norm(dim=-1)
        n = (want.float() - ref).transpose(1, 2).flatten(2).norm(dim=-1)
        return float((d / n.clamp_min(1e-30)).max())
    d = (got.float() - want.float()).norm(dim=-1)
    n = want.float().norm(dim=-1)
    return float((d / (n + FA_FLOOR * n.max()).clamp_min(1e-30)).max())


class Limit(NamedTuple):
    measure: Callable  # (got, plain, grad) -> the number held to the limit
    fwd: float
    grad: float  # dq, dk, dv
    text: str  # what the measure is, for the log


G_TEXT = "forward max |err|, gradients max |err| over the largest element"
G_LIMITS = {"bf16": Limit(g_measure, TOL_G_BF16, TOL_G_GRAD_BF16, G_TEXT), "f32": Limit(g_measure, TOL_G_F32, TOL_G_GRAD_F32, G_TEXT)}
FA_LIMITS = {"bf16": Limit(fa_measure, TOL_FA_BF16, TOL_FA_GRAD_BF16,
                          f"forward: row 2-norm of the error over the row's, floor {FA_FLOOR} of the largest; "
                          "gradients: error against plain float32 over the plain bf16 version's, per (b, h)"),
             "f32": G_LIMITS["f32"]}


def vmem_call(q, k, v, scale):
    from prosody_control_french_tts_tpu_torch.ops import vmem_attn

    return vmem_attn.causal_attention_vmem(q, k, v, scale)


def vmem_plain(q, k, v, scale):
    from prosody_control_french_tts_tpu_torch.ops import vmem_attn

    return vmem_attn.causal_attention_vmem_plain(q, k, v, scale)


def flash_call(q, k, v, scale):
    from prosody_control_french_tts_tpu_torch.ops import flash_attention

    return flash_attention.flash_attention_gqa(q, k, v, scale)


def flash_plain(q, k, v, scale):
    from prosody_control_french_tts_tpu_torch.ops import flash_attention

    return flash_attention.flash_attention_gqa_plain(q, k, v, scale)


def check_attention_kernel(call, plain, name: str, q, k, v, dout, label: str, limits: dict) -> tuple[float, float]:
    """An attention kernel ``call`` (kernel G or the flash attention, as
    fn(q, k, v, scale)) forward and backward against its ``plain`` version,
    in the tensors' dtype and upcast to float32, each held to its ``Limit``
    in ``limits`` ("bf16", "f32"). Returns the working dtype's max |err| of
    the forward and of the gradients."""
    import torch

    scale = float(q.shape[-1] ** -0.5)
    out, failed = {}, []
    casts = [("f32", lambda t: t.float())]
    if q.dtype == torch.bfloat16:
        casts.append(("bf16", lambda t: t))
    ref = None  # the plain version in float32: the first pass's
    for kind, cast in casts:
        lim = limits[kind]
        args = [cast(t) for t in (q, k, v, dout)]
        got = attn_grads(call, *args, scale)
        torch.cuda.synchronize()
        want = attn_grads(plain, *args, scale)
        ref = ref or [w.float() for w in want]
        errs = [lim.measure(a, b, r, i > 0) for i, (a, b, r) in enumerate(zip(got, want, ref))]
        for i, (what, a, b, e) in enumerate(zip(("forward", "dq", "dk", "dv"), got, want, errs)):
            if a.dtype != b.dtype or not torch.isfinite(a).all() or not e <= (lim.grad if i else lim.fwd):
                failed.append(f"{what} ({kind}) {e} beyond {lim.grad if i else lim.fwd}")
        abs_f = float((got[0].float() - want[0].float()).abs().max())
        abs_g = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got[1:], want[1:]))
        out[kind] = (errs, abs_f, abs_g)
        del got, want, args
    print(f"check: {name} {label} q {tuple(q.shape)} k {tuple(k.shape)} {str(q.dtype)[6:]}: " + "; ".join(
        f"{kind} ({limits[kind].text}) forward {e[0]:.3e} (tol {limits[kind].fwd}), dq/dk/dv {' / '.join(f'{x:.3e}' for x in e[1:])} "
        f"(tol {limits[kind].grad}); max |err| forward {af:.3e}, gradients {ag:.3e}" for kind, (e, af, ag) in out.items()))
    if failed:
        raise SystemExit(f"kernel {name} ({label}): " + "; ".join(failed))
    last = out[casts[-1][0]]
    return last[1], last[2]


def check_attention_determinism(call, name: str, q, k, v, dout, label: str) -> None:
    """An attention kernel's backward twice on the same inputs: dq, dk and dv
    bit-equal."""
    import torch

    scale = float(q.shape[-1] ** -0.5)
    first = attn_grads(call, q, k, v, dout, scale)
    second = attn_grads(call, q, k, v, dout, scale)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first[1:], second[1:])]
    print(f"check: {name} {label} {str(q.dtype)[6:]} backward twice: dq, dk, dv bit-equal {same}")
    if not all(same):
        raise SystemExit(f"kernel {name} backward ({label}) is not deterministic: {same}")


def check_h_determinism(h, w, tgt, g, label: str) -> None:
    """Kernel H's backward twice on the same inputs: nll and dh bit-equal."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    first = ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    second = ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(f"check: fused_ce {label} {str(h.dtype)[6:]} forward and backward twice: nll, dh bit-equal {same}")
    if not all(same):
        raise SystemExit(f"kernel H ({label}) is not deterministic: {same}")


def ce_grad(fn, h, w, tgt, g):
    h = h.detach().clone().requires_grad_(True)
    nll = fn(h, w, tgt)
    nll.backward(g)
    return nll.detach(), h.grad


def check_kernel_h(h, w, tgt, g, label: str, tol: float, gtol: float) -> tuple[float, float]:
    """Kernel H forward and backward against its plain version (autograd) on
    the tensors as given. Returns max |err| of the rows and of dh."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    got, got_dh = ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    torch.cuda.synchronize()
    want, want_dh = ce_grad(fused_ce.linear_ce_rows_plain, h, w, tgt, g)
    diff = (got - want).abs()
    if not torch.isfinite(got).all() or bool((diff > tol + tol * want.abs()).any()):
        raise SystemExit(f"kernel H forward ({label}): max |err| {float(diff.max())} beyond {tol}")
    d = float((got_dh.float() - want_dh.float()).abs().max())
    ref = float(want_dh.float().abs().max())
    if got_dh.dtype != h.dtype or not torch.isfinite(got_dh).all() or d > gtol * ref:
        raise SystemExit(f"kernel H backward ({label}): dh differs by {d} with largest element {ref} (tol {gtol} relative)")
    print(f"check: fused_ce {label} h {tuple(h.shape)} w {tuple(w.shape)} {str(h.dtype)[6:]}: rows max |err| {float(diff.max()):.3e} (tol {tol}), "
          f"dh max |err| {d:.3e} = {d / ref:.3e} of the largest element (tol {gtol})")
    return float(diff.max()), d


def edge_shape_checks(seed: int) -> None:
    """Kernels G and H against their plain versions on edge shapes: L 128,
    one KV head, N that fills no tile, a target in the last vocabulary
    column, logits scaled x12; for H's bfloat16 kernels also D 128 (a
    contraction shorter than the 4-stage ring), N 1, 63, 65 and 2,044 (the
    warpgroup halves and the 7B row count), V 512 (two vocabulary tiles),
    in both types."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    for B, L, H, KV, hd, dtype in ((3, 128, 6, 6, 128, torch.float32), (2, 128, 8, 1, 64, torch.bfloat16), (1, 512, 14, 2, 64, torch.float32)):
        check_attention_kernel(vmem_call, vmem_plain, "vmem_attn", mk(B, L, H, hd).to(dtype), mk(B, L, KV, hd).to(dtype),
                               mk(B, L, KV, hd).to(dtype), mk(B, L, H, hd).to(dtype), f"edge B {B} L {L} H {H} KV {KV} hd {hd}", G_LIMITS)
    for N, D, V, spread in ((300, 256, 1024, 1.0), (515, 384, 9216, 1.0), (8, 128, 512, 1.0), (300, 256, 1024, 12.0)):
        h = mk(N, D) * 0.3 * spread
        w = mk(D, V) * 0.05 * spread
        tgt = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).cuda()
        tgt[0], tgt[-1] = V - 1, 0
        g = (torch.from_numpy(rng.random(N)).cuda() > 0.3).float()
        g = g / g.sum()
        if spread == 1.0:
            check_kernel_h(h, w, tgt, g, f"edge N {N} D {D} V {V}", TOL_H_F32, TOL_H_GRAD_F32)
        else:
            got = fused_ce.linear_ce_rows(h, w, tgt)
            want = fused_ce.linear_ce_rows_plain(h, w, tgt)
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool((diff > TOL_H_EXTREME + TOL_H_EXTREME * want.abs()).any()):
                raise SystemExit(f"kernel H forward (logits x12): max |err| {float(diff.max())} beyond {TOL_H_EXTREME}")
            print(f"check: fused_ce logits x12 (max |logit| {float((h @ w).abs().max()):.0f}): rows max |err| {float(diff.max()):.3e} (tol {TOL_H_EXTREME})")
    for N, D, V in ((1, 128, 512), (63, 128, 1024), (65, 256, 2048), (2044, 128, 512), (2044, 128, 65536)):
        h = mk(N, D) * 0.3
        w = mk(D, V) * 0.05
        tgt = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).cuda()
        tgt[0], tgt[-1] = V - 1, V - 1
        g = torch.full((N,), 1.0 / N, device="cuda")
        check_kernel_h(h.bfloat16(), w.bfloat16(), tgt, g, f"edge N {N} D {D} V {V}", TOL_H_WIDE, TOL_H_GRAD_BF16)
        check_kernel_h(h, w, tgt, g, f"edge N {N} D {D} V {V}", TOL_H_F32, TOL_H_GRAD_F32)


def h_peak_allocation(h, w, tgt, g) -> int:
    """Peak of newly allocated device memory during kernel H's forward and
    backward: it must stay under N * V * 2 bytes, the size of the bfloat16
    logits that the fused loss never makes."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    limit = h.shape[0] * w.shape[1] * 2
    print(f"check: fused_ce forward + backward at N {h.shape[0]}, V {w.shape[1]} newly allocated at most {peak / 1e6:.1f} MB "
          f"(an [N, V] bfloat16 tensor is {limit / 1e6:.1f} MB)")
    if peak >= limit:
        raise SystemExit(f"kernel H allocated {peak} bytes, an [N, V] tensor's worth")
    return peak


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn(): ``reps`` calls captured into one CUDA graph
    (after three eager calls on a side stream), the graph replayed between two
    CUDA events. A replay has no host path between its kernels, so this reads
    device time for calls of any length, eager PyTorch code included."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fwd_bwd_ms(make_call, sets, reps: int) -> dict:
    """Device ms of a forward alone and of the backward (forward + backward
    less the forward), by graph_ms, rotating over ``sets`` of input tensors so
    that L2 is cold. ``make_call(inputs, grad)`` returns (output, gradient to
    send back, inputs that take a gradient). (Kernel durations summed under
    torch.profiler, as device_ms does for kernel F, lost records in this
    process once the trainers had run; a loop between events reads the host
    for the library attention, whose kernels take about 0.02 ms.)"""
    import torch

    turn = [0]

    def forward_only():
        turn[0] += 1
        with torch.no_grad():
            make_call(sets[turn[0] % len(sets)], False)

    def forward_backward():
        turn[0] += 1
        out, grad, leaves = make_call(sets[turn[0] % len(sets)], True)
        torch.autograd.grad(out, leaves, grad)

    fwd = graph_ms(forward_only, reps)
    both = graph_ms(forward_backward, reps)
    return dict(fwd=fwd, bwd=both - fwd)


def kernel_time_rows(ms, plain, lib, work, peak) -> dict:
    """Rows {"fwd": ..., "bwd": ...} of a kernel's times beside its bound:
    the larger of bytes over the memory rate and operations over ``peak``."""
    out = {}
    for name, (flops, nbytes) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = dict(ms=ms[name], plain_ms=plain[name], library_ms=lib[name], bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def time_kernel_g(q, k, v, dout) -> dict:
    """Kernel G, its plain version and scaled_dot_product_attention
    (is_causal, enable_gqa), forward and backward, on a captured layer's
    tensors, L2 cold (enough copies to exceed the 50 MB cache)."""
    import torch
    import torch.nn.functional as F

    from prosody_control_french_tts_tpu_torch.ops import vmem_attn

    B, L, H, hd = q.shape
    KV = k.shape[2]
    item = q.element_size()
    scale = float(hd**-0.5)
    one = (2 * q.numel() + 2 * k.numel()) * item
    sets = [tuple(t.clone() for t in (q, k, v, dout)) for _ in range(max(2, int(120e6 // one) + 1))]

    def with_fn(fn):
        def make_call(inputs, grad):
            qq, kk, vv, dd = inputs
            if grad:
                qq, kk, vv = (t.detach().requires_grad_(True) for t in (qq, kk, vv))
            return fn(qq, kk, vv), dd, (qq, kk, vv)

        return make_call

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), is_causal=True, enable_gqa=True).transpose(1, 2)

    ms = fwd_bwd_ms(with_fn(lambda a, b, c: vmem_attn.causal_attention_vmem(a, b, c, scale)), sets, reps=12)
    plain = fwd_bwd_ms(with_fn(lambda a, b, c: vmem_attn.causal_attention_vmem_plain(a, b, c, scale)), sets, reps=4)
    lib = fwd_bwd_ms(with_fn(sdpa), sets, reps=12)
    pairs = B * H * L * (L + 1) // 2  # (query, key) pairs at or below the diagonal
    stat = B * H * L * 4
    work = {"fwd": (2 * 2 * hd * pairs, (2 * q.numel() + 2 * k.numel()) * item + stat),
            "bwd": (5 * 2 * hd * pairs, (3 * q.numel() + 4 * k.numel()) * item + stat)}
    out = kernel_time_rows(ms, plain, lib, work, PEAK_FLOPS["bf16" if item == 2 else "f32"])
    out["shape"] = dict(B=B, L=L, H=H, kv_heads=KV, hd=hd, dtype=str(q.dtype)[6:])
    return out


def time_kernel_fa(q, k, v, dout) -> dict:
    """The flash attention on a captured layer's own tensors in the model's
    layout (q [B, L, H, hd], k, v [B, L, KVH, hd]), its plain version, and
    scaled_dot_product_attention (is_causal) on [B, H, L, hd] with K/V
    repeated to all heads (copies made before the timing, the yardstick of
    PERF.md's earlier rows), forward and backward, L2 cold (enough copies to
    exceed the 50 MB cache). Work: 4 hd operations per (query, key) pair at or
    below the diagonal forward, 10 hd backward; bytes: q, k, v (at KVH heads)
    read and o, l, m written forward; q, k, v, o, do, l, m read and dq, dk,
    dv written backward."""
    import torch.nn.functional as F

    from prosody_control_french_tts_tpu_torch.ops import flash_attention

    B, L, H, hd = q.shape
    KVH = k.shape[2]
    group = H // KVH
    item = q.element_size()
    scale = float(hd**-0.5)
    one = (2 * q.numel() + 2 * k.numel()) * item
    sets = [tuple(t.clone() for t in (q, k, v, dout)) for _ in range(max(2, int(120e6 // one) + 1))]
    lib_sets = [(a.transpose(1, 2).contiguous(), flash_attention.repeat_kv(b, group).contiguous(),
                 flash_attention.repeat_kv(c, group).contiguous(), d.transpose(1, 2).contiguous()) for a, b, c, d in sets]

    def with_fn(f):
        def make_call(inputs, grad):
            qq, kk, vv, dd = inputs
            if grad:
                qq, kk, vv = (t.detach().requires_grad_(True) for t in (qq, kk, vv))
            return f(qq, kk, vv), dd, (qq, kk, vv)

        return make_call

    ms = fwd_bwd_ms(with_fn(lambda a, b, c: flash_call(a, b, c, scale)), sets, reps=12)
    plain = fwd_bwd_ms(with_fn(lambda a, b, c: flash_plain(a, b, c, scale)), sets, reps=2)
    lib = fwd_bwd_ms(with_fn(lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True)), lib_sets, reps=12)
    del lib_sets
    pairs = B * H * L * (L + 1) // 2
    stat = B * H * L * 4
    work = {"fwd": (2 * 2 * hd * pairs, (2 * q.numel() + 2 * k.numel()) * item + 2 * stat),
            "bwd": (5 * 2 * hd * pairs, (4 * q.numel() + 4 * k.numel()) * item + 2 * stat)}
    out = kernel_time_rows(ms, plain, lib, work, PEAK_FLOPS["bf16" if item == 2 else "f32"])
    out["shape"] = dict(B=B, L=L, H=H, kv_heads=KVH, hd=hd, dtype=str(q.dtype)[6:])
    return out


def time_kernel_h(h, w, tgt, g) -> dict:
    """Kernel H, its plain version and F.cross_entropy of the dense logits,
    forward and backward (dh only), on the captured final hidden state. W is
    far larger than L2, so every call finds it cold."""
    import torch
    import torch.nn.functional as F

    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    N, D = h.shape
    V = w.shape[1]
    item = h.element_size()
    sets = [(h, w, tgt, g), (h.clone(), w, tgt, g)]

    def with_fn(fn):
        def make_call(inputs, grad):
            hh, ww, tt, gg = inputs
            if grad:
                hh = hh.detach().requires_grad_(True)
            return fn(hh, ww, tt), gg, (hh,)

        return make_call

    t64 = tgt.long()
    ms = fwd_bwd_ms(with_fn(fused_ce.linear_ce_rows), sets, reps=2)
    plain = fwd_bwd_ms(with_fn(fused_ce.linear_ce_rows_plain), sets, reps=2)
    lib = fwd_bwd_ms(with_fn(lambda hh, ww, tt: F.cross_entropy(hh @ ww, t64, reduction="none").float()), sets, reps=2)
    work = {"fwd": (2 * N * D * V, (N * D + D * V) * item + N * 12), "bwd": (4 * N * D * V, (2 * N * D + D * V) * item + N * 12)}
    out = kernel_time_rows(ms, plain, lib, work, PEAK_FLOPS["bf16" if item == 2 else "f32"])
    out["shape"] = dict(N=N, D=D, V=V, dtype=str(h.dtype)[6:])
    return out


def flash_phase(args, card: str, free) -> tuple:
    """Phase 14 of the module docstring: the long-sequence LoRA trainers with
    attn_impl="flash", the loss-curve parity at L 256, the flash attention
    against its plain version on the 7B step's tensors and its times. Returns
    (the rows of its forward and backward for the ``kernels`` line, the
    trainers' step-split functions, their stats)."""
    import dataclasses

    from prosody_control_french_tts_tpu_torch.models import llm

    cfg7 = dataclasses.replace(llm.LLMConfig.qwen25_7b(), attn_impl="flash", fused_qkv=True, lora_rank=8)
    counts7, cap7, stats7, split7 = run_trainer("7B L 1024 flash", cfg7, 2, 1024, args.seed + 3, card, scan=False, dot_peak=True)
    free()
    bcfg = llm.LLMConfig(vocab_size=32768, dim=896, layers=12, heads=14, kv_heads=2, ffn=2432, max_len=768, lora_rank=8,
                         attn_impl="flash", fused_qkv=True)
    countsb, capb, statsb, splitb = run_trainer("bench geometry L 768 flash", bcfg, 8, 768, args.seed + 4, card, scan=True)
    free()
    parity_on_card(args.seed, "flash", 256)

    errs, times = {}, {}
    for label, cap in (("7B L 1024", cap7), ("bench geometry L 768", capb)):
        errs[label] = check_attention_kernel(flash_call, flash_plain, "flash_attention", cap["q"], cap["k"], cap["v"], cap["dout"], label,
                                             FA_LIMITS)
        free()
    check_attention_determinism(flash_call, "flash_attention", cap7["q"], cap7["k"], cap7["v"], cap7["dout"], "7B L 1024")
    for label, cap in (("7B L 1024", cap7), ("bench geometry L 768", capb)):
        times[label] = time_kernel_fa(cap["q"], cap["k"], cap["v"], cap["dout"])
        free()
    rows = []
    for spec, i, direction in ((KERNEL_FA_FWD, 0, "fwd"), (KERNEL_FA_BWD, 1, "bwd")):
        t7, tb = times["7B L 1024"], times["bench geometry L 768"]
        rows.append(dict(spec, launches=counts7[spec["name"]], max_abs_err=errs["7B L 1024"][i],
                         **{k: t7[direction][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, check="pass", shape=t7["shape"],
                         bench_geometry=dict(tb[direction], shape=tb["shape"], launches=countsb[spec["name"]], max_abs_err=errs["bench geometry L 768"][i])))
        prev = FA_PREVIOUS_MS[direction]
        for label, t, n, was in (("7B L 1024", t7, counts7[spec["name"]], prev[0]), ("bench geometry L 768", tb, countsb[spec["name"]], prev[1])):
            d = t[direction]
            print(f"kernel {spec['name']} ({label} {json.dumps(t['shape'])}): ms={d['ms']:.4f} launches={n} bound_ms={d['bound_ms']:.5f} "
                  f"({d['bound_by']}: {d['bytes']} bytes, {d['flops']} flops) plain_ms={d['plain_ms']:.4f} library_ms={d['library_ms']:.4f} "
                  f"(SDPA is_causal, K/V repeated; {d['ms'] / d['library_ms']:.2f}x) (PERF.md's mma.sync design: {was} ms, "
                  f"{was / d['ms']:.2f}x this run's time) card={card}")
    return rows, (split7, splitb), (stats7, statsb)


def train_phases(args, card: str) -> list:
    """Phases 11-14 of the module docstring. Returns the rows of G forward, G
    backward, H forward, H backward and the flash attention's forward and
    backward for the ``kernels`` line."""
    import dataclasses
    import gc

    import torch

    from prosody_control_french_tts_tpu_torch.models import llm

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- 11. trainers ----------------------------------------------------------
    free()  # the serving trees are gone: return their blocks before the 7B trainer
    cfg7 = dataclasses.replace(llm.LLMConfig.qwen25_7b(), attn_impl="vmem", fused_qkv=True, lora_rank=8)
    counts7, cap7, stats7, split7 = run_trainer("7B", cfg7, 4, 512, args.seed, card, scan=False)
    free()
    bcfg = llm.LLMConfig(vocab_size=32768, dim=896, layers=12, heads=14, kv_heads=2, ffn=2432, max_len=512, lora_rank=8,
                         attn_impl="vmem", fused_qkv=True)
    countsb, capb, statsb, splitb = run_trainer("bench geometry", bcfg, 8, 512, args.seed + 2, card, scan=True)
    free()

    # -- 12. parity on the card -------------------------------------------------
    parity_on_card(args.seed)

    # -- 13. kernels against their plain versions, and their times ---------------
    errs = {}
    for label, cap in (("7B geometry", cap7), ("bench geometry", capb)):
        g_err = check_attention_kernel(vmem_call, vmem_plain, "vmem_attn", cap["q"], cap["k"], cap["v"], cap["dout"], label, G_LIMITS)
        h_err = check_kernel_h(cap["h"], cap["w"], cap["tgt"], cap["g"], label + " bf16", TOL_H_WIDE, TOL_H_GRAD_BF16)
        check_kernel_h(cap["h"].float(), cap["w"].float(), cap["tgt"], cap["g"], label + " upcast to float32", TOL_H_WIDE, TOL_H_GRAD_WIDE)
        free()
        errs[label] = (g_err, h_err)
    check_attention_determinism(vmem_call, "vmem_attn", cap7["q"], cap7["k"], cap7["v"], cap7["dout"], "7B geometry")
    check_h_determinism(cap7["h"], cap7["w"], cap7["tgt"], cap7["g"], "7B geometry")
    edge_shape_checks(args.seed)
    h_peak_allocation(cap7["h"], cap7["w"], cap7["tgt"], cap7["g"])
    times = {}
    for label, cap in (("7B geometry", cap7), ("bench geometry", capb)):
        times[label] = (time_kernel_g(cap["q"], cap["k"], cap["v"], cap["dout"]), time_kernel_h(cap["h"], cap["w"], cap["tgt"], cap["g"]))
        free()

    rows = []
    for spec, which, direction in ((KERNEL_G_FWD, 0, "fwd"), (KERNEL_G_BWD, 0, "bwd"), (KERNEL_H_FWD, 1, "fwd"), (KERNEL_H_BWD, 1, "bwd")):
        i = 0 if direction == "fwd" else 1
        t7, tb = times["7B geometry"][which], times["bench geometry"][which]
        prev = (G_PREVIOUS_MS if which == 0 else H_PREVIOUS_MS)[direction]
        rows.append(dict(spec, launches=counts7[spec["name"]], max_abs_err=errs["7B geometry"][which][i],
                         **{k: t7[direction][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, check="pass", shape=t7["shape"],
                         bench_geometry=dict(tb[direction], shape=tb["shape"], launches=countsb[spec["name"]], max_abs_err=errs["bench geometry"][which][i])))
        for label, t, n, was in (("7B geometry", t7, counts7[spec["name"]], prev[0]), ("bench geometry", tb, countsb[spec["name"]], prev[1])):
            d = t[direction]
            design = "CUDA-core" if which == 0 else "wmma"
            before = f" (PERF.md's {design} design: {was} ms, {was / d['ms']:.1f}x this run's time)"
            print(f"kernel {spec['name']} ({label} {json.dumps(t['shape'])}): ms={d['ms']:.4f} launches={n} bound_ms={d['bound_ms']:.5f} "
                  f"({d['bound_by']}: {d['bytes']} bytes, {d['flops']} flops) plain_ms={d['plain_ms']:.4f} library_ms={d['library_ms']:.4f}{before} card={card}")

    # -- 14. long-sequence training with the flash attention ------------------
    fa_rows, fa_splits, (stats7f, statsbf) = flash_phase(args, card, free)
    rows.extend(fa_rows)

    for split in (split7, splitb, *fa_splits):
        split()
    del split7, splitb, fa_splits
    free()
    print(f"train summary: 7B {stats7['warm_ms']:.1f} ms per step, {stats7['tokens_per_s']:.1f} tokens/s, peak {stats7['peak_gb']:.2f} GB; "
          f"bench geometry {statsb['warm_ms']:.1f} ms per step, {statsb['tokens_per_s']:.1f} tokens/s, peak {statsb['peak_gb']:.2f} GB; "
          f"7B L 1024 flash {stats7f['warm_ms']:.1f} ms per step, {stats7f['tokens_per_s']:.1f} tokens/s, peak {stats7f['peak_gb']:.2f} GB "
          f"(dot path {stats7f['dot_peak_gb']:.2f} GB); bench geometry L 768 flash {statsbf['warm_ms']:.1f} ms per step, "
          f"{statsbf['tokens_per_s']:.1f} tokens/s, peak {statsbf['peak_gb']:.2f} GB; card={card}")
    return rows


# ---------------------------------------------------------------------------
# the acoustic aligners (Whisper, CTC) and the eight-step pipeline with them
# ---------------------------------------------------------------------------

# the JAX package's accuracy gates (tests/test_whisper_pretrained.py:56-63,
# tests/test_ctc_pretrained.py:35-41)
ALIGN_GATE_MS = 80.0
WHISPER_MIN_ACCURACY = 0.85
# card vs CPU: equal words, every boundary within one encoder frame (20 ms).
# The card's bfloat16 products add in another order than the CPU's; a score
# that rounds the other way moves the attention by a few per cent, and a DP
# choice between nearly equal paths by a frame
TOL_ALIGN_S = 0.02
CTC_VOCAB = 47  # the CTC aligner's classes with the blank (align/ctc_aligner.py)
KERNEL_CTC = dict(
    name="ctc_viterbi",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/ctc_viterbi.cu",
    replaces="prosody_control_french_tts_tpu/align/ctc.py:72",
    also_replaces="prosody_control_french_tts_tpu/align/ctc.py:88",
)
ALIGN_SEGMENTS = 10
# pauses between the sentences of a segment: past the aligners' VAD window
# (400 ms), so that each sentence is a region of its own, and under the
# silence split's (1 s), so that the segments stay whole
ALIGN_PAUSES_S = (0.5, 0.9)
SMALL_DECODE = dict(batch=16, max_new=128)
# the pipeline's segment words against the gold spans: mean |boundary error|
# under the aligners' gate, and word accuracy at least this. Whisper
# transcribes: its own gate asks 0.85 of 8 sentences, where it reads 0.854
# on the CPU in both packages; over this voice's ~550 words the CPU read
# 0.852, and 0.80 leaves room for the card's roundings. CTC is forced with
# the exact sentences: every word
PIPE_MIN_ACCURACY = {"whisper": 0.80, "ctc": 0.99}


def tg_words(tg):
    return [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]


def same_words(want, got, label: str, tol: float = TOL_ALIGN_S) -> float:
    """Equal marks, every boundary within ``tol`` → the largest difference."""
    if [w for *_, w in got] != [w for *_, w in want]:
        raise SystemExit(f"{label}: words differ: {[w for *_, w in want]} vs {[w for *_, w in got]}")
    err = max((max(abs(a0 - b0), abs(a1 - b1)) for (a0, a1, _), (b0, b1, _) in zip(want, got)), default=0.0)
    if err > tol + 1e-6:
        raise SystemExit(f"{label}: boundaries differ by {err:.3f} s (limit {tol} s)")
    return err


def whisper_align_phase(card: str) -> dict:
    """Phase 16: the packaged Whisper aligner on the card, the JAX bench's
    whisper_align shape (12 held-out synthetic sentences, transcript-free,
    one ``align_batch``), cold and warm, with the split of the warm call;
    the JAX package's accuracy gate; card against CPU on three clips."""
    import torch

    from prosody_control_french_tts_tpu_torch.align.pretrain_whisper import boundary_error_ms
    from prosody_control_french_tts_tpu_torch.align.synth_speech import SynthSpec, sample_sentences, synth_sentence
    from prosody_control_french_tts_tpu_torch.align.whisper import WhisperAligner
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio

    al = WhisperAligner()
    clips = [Audio(synth_sentence(s, seed=900_000 + i)[0], 16000) for i, s in enumerate(sample_sentences(12, seed=900_000))]
    audio_s = sum(c.duration_seconds for c in clips)
    times, splits = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tgs = al.align_batch(clips)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        splits.append(dict(al.last_split))
    if not all(tg_words(tg) for tg in tgs):
        raise SystemExit("whisper align: a clip without words")
    trace = profile_measure(lambda: al.align_batch(clips))
    err_ms, acc = boundary_error_ms(al, sample_sentences(8, seed=555_000), SynthSpec())
    if not (err_ms < ALIGN_GATE_MS and acc > WHISPER_MIN_ACCURACY):
        raise SystemExit(f"whisper align gate: boundary error {err_ms:.1f} ms, word accuracy {acc:.3f}")
    cpu = WhisperAligner(device="cpu")
    diff = max(same_words(tg_words(c), tg_words(g), f"whisper clip {i} card vs CPU")
               for i, (g, c) in enumerate(zip(al.align_batch(clips[:3]), cpu.align_batch(clips[:3]))))
    warm = splits[1]
    print(f"whisper align (12 clips, {audio_s:.2f} s of audio, transcript-free): warm {times[1]:.4f} s, "
          f"{audio_s / times[1]:.2f} audio-s/s; cold {times[0]:.3f} s; card={card}")
    print("whisper align split warm (s; greedy steps): " + json.dumps({k: round(v, 5) for k, v in warm.items()})
          + "; cold: " + json.dumps({k: round(v, 5) for k, v in splits[0].items()}))
    print(f"whisper align gate (8 held-out sentences, seed 555000): boundary error {err_ms:.2f} ms (< {ALIGN_GATE_MS}), "
          f"word accuracy {acc:.3f} (> {WHISPER_MIN_ACCURACY}); card vs CPU on 3 clips: equal words, "
          f"max boundary difference {diff:.3f} s")
    print("profile (warm whisper align_batch): " + json.dumps(trace))
    return dict(audio_s=audio_s, warm_s=times[1], cold_s=times[0], split=warm, err_ms=err_ms, acc=acc,
                busy=trace["device_busy_share"])


def whisper_small_decode_phase(card: str, seed: int) -> dict:
    """Phase 17: the decode pass at ``WhisperConfig.small()`` widths (dim
    768, 12 + 12 layers, 1,500 encoder frames, vocab 51,865) with random
    weights made on the card, batch 16, the full 128 steps (eot's embedding
    row is zero, so its logit is 0 and never the largest); timing only."""
    import torch

    from prosody_control_french_tts_tpu_torch.align.whisper import WhisperConfig, WhisperModel, _Marks, make_greedy_spans_fn

    cfg = WhisperConfig.small()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = WhisperModel(cfg).to(dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
        eot, sot = cfg.vocab_size - 1, cfg.vocab_size - 2
        model.decoder.tok_emb.embedding[eot] = 0.0
    model.eval()
    B, max_new = SMALL_DECODE["batch"], SMALL_DECODE["max_new"]
    mel = torch.randn((B, 2 * cfg.n_audio_ctx, cfg.n_mels), generator=gen, device=dev)
    fr = torch.full((B,), cfg.n_audio_ctx, dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    fn = make_greedy_spans_fn(model, max_new)
    out = {}
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        marks = _Marks(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, n, spans = fn(mel, sot, eot, fr, active, marks=marks)
        torch.cuda.synchronize()
        out[label] = dict(seconds=time.perf_counter() - t0, steps=fn.steps, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          split_ms=marks.read())
    w = out["warm"]
    if w["steps"] != max_new or not bool((n == max_new).all()) or not torch.isfinite(spans).all():
        raise SystemExit(f"whisper small decode: {w['steps']} steps, n {n.tolist()}")
    step_ms = w["split_ms"]["greedy_s"] / (w["steps"] + 1)
    print(f"whisper small decode (dim 768, 12 + 12 layers, 1,500 frames, vocab 51,865, batch {B}, {max_new} steps, random "
          f"weights): warm {w['seconds']:.3f} s a call, {step_ms:.3f} ms a decode step (greedy loop by CUDA events over "
          f"{w['steps']} + 1 steps), encoder + cross K/V {w['split_ms']['encode_s']:.2f} ms, DTW spans "
          f"{w['split_ms']['dtw_s']:.2f} ms, peak device memory {w['peak_gb']:.2f} GB; cold {out['cold']['seconds']:.3f} s; "
          f"card={card}")
    return dict(seconds=w["seconds"], step_ms=step_ms, peak_gb=w["peak_gb"], split_ms=w["split_ms"])


def ctc_align_phase(card: str) -> dict:
    """Phase 18: the packaged CTC aligner on the card: the JAX package's
    gate, card against CPU on three clips; the Viterbi's calls captured."""
    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner
    from prosody_control_french_tts_tpu_torch.align.pretrain_ctc import boundary_error_ms
    from prosody_control_french_tts_tpu_torch.align.synth_speech import SynthSpec, sample_sentences, synth_sentence
    from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio

    al = CTCAligner()
    sents = sample_sentences(6, seed=555_000)
    ctc_viterbi.launches = 0
    with Capture(ctc_viterbi, "ctc_viterbi") as cap:
        err_ms = boundary_error_ms(al, sents, SynthSpec())
    if ctc_viterbi.launches != len(sents):
        raise SystemExit(f"ctc align: {ctc_viterbi.launches} Viterbi launches for {len(sents)} sentences")
    if not err_ms < ALIGN_GATE_MS:
        raise SystemExit(f"ctc align gate: boundary error {err_ms:.1f} ms")
    cpu = CTCAligner(device="cpu")
    diff = 0.0
    for i, s in enumerate(sample_sentences(3, seed=321_000)):
        a = Audio(synth_sentence(s, seed=321_000 + i)[0], 16000)
        diff = max(diff, same_words(tg_words(cpu.align(a, s)), tg_words(al.align(a, s)), f"ctc clip {i} card vs CPU"))
    print(f"ctc align gate (6 held-out sentences, seed 555000): boundary error {err_ms:.2f} ms (< {ALIGN_GATE_MS}); "
          f"card vs CPU on 3 clips: equal words, max boundary difference {diff:.3f} s; card={card}")
    return dict(err_ms=err_ms, calls=list(cap.calls))


def build_aligner_voice(base: Path, name: str, seed: int):
    """A brute recording of synthetic French sentences (``align.synth_speech``,
    16 kHz): ALIGN_SEGMENTS segments of 8–23 s, the sentences of a segment
    ALIGN_PAUSES_S apart, the segments PIPE_GAP_S of zeros apart, resampled to
    44.1 kHz into ``Data/voice/<name>/brute/segment.wav``. Returns (each
    segment's sentences joined, the gold words [(t0, t1, word)] in seconds of
    the recording, its audio seconds)."""
    import numpy as np

    from prosody_control_french_tts_tpu_torch.align.synth_speech import sample_sentences, synth_sentence
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio, resample, write_wav

    sr = 16000
    rng = np.random.default_rng(seed)
    pool = iter(enumerate(sample_sentences(400, seed=seed)))
    parts, texts, gold, t = [], [], [], 0.0
    nxt = None
    for k in range(ALIGN_SEGMENTS):
        target, dur, seg = rng.uniform(8.0, 23.0), 0.0, []
        while True:
            if nxt is None:
                i, sent = next(pool)
                nxt = (sent, *synth_sentence(sent, seed=seed * 1000 + i))
            sent, a, g = nxt
            pause = rng.uniform(*ALIGN_PAUSES_S) if seg else 0.0
            if seg and (dur >= target or dur + pause + a.size / sr > 23.0):
                break
            parts.append(np.zeros(int(round(pause * sr)), np.float32))
            t += int(round(pause * sr)) / sr
            gold += [(t + w0, t + w1, w) for w0, w1, w in g]
            parts.append(np.asarray(a, np.float32))
            t += a.size / sr
            dur += pause + a.size / sr
            seg.append(sent)
            nxt = None
        texts.append(" ".join(seg))
        if k < ALIGN_SEGMENTS - 1:
            parts.append(np.zeros(int(PIPE_GAP_S * sr), np.float32))
            t += PIPE_GAP_S
    x = np.concatenate(parts)
    brute = base / "Data" / "voice" / name / "brute"
    brute.mkdir(parents=True)
    write_wav(brute / "segment.wav", np.asarray(resample(Audio(x, sr), 44100).samples, np.float32), 44100)
    return texts, gold, x.size / sr


def aligner_config(base: Path, name: str, aligner: str):
    from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig

    return PipelineConfig.from_dict({
        "data_dir": "Data/voice", "out_dir": "Out", "voice_names": [name], "azure_voice_name": "fr-FR-DeniseNeural",
        "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
        "tts_backend": "fake", "aligner": aligner,
    }, base)


def words_against_gold(pipe, gold) -> tuple[float, float]:
    """The segment TextGrids' words, moved to the recording's time by their
    silence-split offsets, against the gold words: (mean |boundary error| ms
    over the matched words, word accuracy), words matched by sequence
    alignment (difflib) as the Whisper gate matches them."""
    from difflib import SequenceMatcher

    import numpy as np

    from prosody_control_french_tts_tpu_torch.prosody.measure import segment_sort_key
    from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid

    got = []
    segs = sorted((pipe.voice_dir / "audio").glob("*.wav"), key=segment_sort_key)
    for seg, (s_ms, _) in zip(segs, pipe.last_split):
        got += [(t0 + s_ms / 1000.0, t1 + s_ms / 1000.0, w) for t0, t1, w in tg_words(read_textgrid(pipe.textgrid_dir / f"{seg.stem}.TextGrid"))]
    sm = SequenceMatcher(a=[w.lower() for *_, w in gold], b=[w.lower() for *_, w in got], autojunk=False)
    errs, hit = [], 0
    for blk in sm.get_matching_blocks():
        for k in range(blk.size):
            hit += 1
            errs += [abs(gold[blk.a + k][0] - got[blk.b + k][0]), abs(gold[blk.a + k][1] - got[blk.b + k][1])]
    return (1000.0 * float(np.mean(errs)) if errs else float("inf")), hit / max(len(gold), 1)


def aligner_pipeline_phase(tmp: Path, seed: int, card: str) -> dict:
    """Phase 19: the eight steps with ``aligner: whisper`` (transcript-free,
    as the JAX bench runs it), cold and warm, each on a fresh copy of the
    voice; once more with ``aligner: ctc`` and the sentences as raw
    transcripts. Kernel counts, artifacts, words against the gold spans."""
    import torch

    from prosody_control_french_tts_tpu_torch.core import profiling
    from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
    from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi
    from prosody_control_french_tts_tpu_torch.prosody.measure import segment_sort_key

    dev = torch.device("cuda")
    out = {}
    for label in ("cold", "warm", "ctc"):
        aligner = "ctc" if label == "ctc" else "whisper"
        base = tmp / f"aligners_{label}"
        t0 = time.perf_counter()
        texts, gold, audio_s = build_aligner_voice(base, "aligned", seed + 7)
        made_s = time.perf_counter() - t0
        pipe = AudioPipeline("aligned", aligner_config(base, "aligned", aligner), device=dev)
        reset_kernel_counts()
        ctc_viterbi.launches = 0
        profiling.reset_phases()
        with Capture(ctc_viterbi, "ctc_viterbi") as cap:
            if aligner == "ctc":
                pre, pre_s = run_steps(pipe, ["Preprocess"])
                segs = sorted((pipe.voice_dir / "audio").glob("*.wav"), key=segment_sort_key)
                if len(segs) != len(texts):
                    raise SystemExit(f"aligner pipeline: the silence split gave {len(segs)} segments of {len(texts)}")
                pipe.transcription_raw_dir.mkdir(parents=True, exist_ok=True)
                for seg, text in zip(segs, texts):
                    (pipe.transcription_raw_dir / f"{seg.stem}.txt").write_text(text, encoding="utf-8")
                rest, rest_s = run_steps(pipe, pipe.STEP_NAMES[1:])
                records, wall = pre + rest, pre_s + rest_s
            else:
                records, wall = run_steps(pipe, None)
        counts = dict(kernel_counts(), ctc_viterbi=ctc_viterbi.launches)
        if len(pipe.last_split) != ALIGN_SEGMENTS:
            raise SystemExit(f"aligner pipeline {label}: {len(pipe.last_split)} segments of {ALIGN_SEGMENTS}")
        want_ctc = ALIGN_SEGMENTS + 1 if aligner == "ctc" else 0
        if counts["pitch_candidates"] != 1 or counts["viterbi"] != 1 or counts["ctc_viterbi"] != want_ctc:
            raise SystemExit(f"aligner pipeline {label}: launches {counts} (A and B once, ctc_viterbi {want_ctc})")
        check_pipeline_artifacts(pipe, ALIGN_SEGMENTS, aligner=aligner)
        err_ms, acc = words_against_gold(pipe, gold)
        if not (err_ms < ALIGN_GATE_MS and acc >= PIPE_MIN_ACCURACY[aligner]):
            raise SystemExit(f"aligner pipeline {label}: words against gold: boundary error {err_ms:.1f} ms, accuracy {acc:.3f}")
        rep = pipe.last_breaks
        print(f"aligner pipeline {label} (aligner: {aligner}; {ALIGN_SEGMENTS} segments, {audio_s:.1f} s of audio, made in "
              f"{made_s:.1f} s): eight steps {wall:.3f} s, {audio_s / wall:.2f} audio-s/s; launches {json.dumps(counts)}; "
              f"words against gold: boundary error {err_ms:.2f} ms, accuracy {acc:.3f}; breaks {rep.within}/{rep.total} "
              f"within 5 ms; card={card}")
        print(f"aligner pipeline {label} steps (s): " + json.dumps(per_step(records)))
        print(f"aligner pipeline {label} phases: " + json.dumps({k: round(v, 4) for k, v in sorted(profiling.PHASES.items())}))
        out[label] = dict(wall=wall, audio_s=audio_s, counts=counts, calls=list(cap.calls), steps=per_step(records))
    return out


def ctc_kernel_row(calls, pipeline_launches: int, card: str, lib) -> dict:
    """ctc_viterbi against its plain version on every captured call (states
    and score bit for bit; the plain version, with its [T, S] gather, on the
    CPU), then its time on the largest call (the pipeline's Final
    Transcribe): the kernel alone as a CUDA-graph replay beside the plain
    version on the card, ``ctc_forced_align`` as a whole call (host wall,
    synchronised: the host checks and the one upload included), the bytes
    bound (the advanced frames' log-probabilities [Tv, V] read once, 2-bit
    pointers written and read once, the states written, the states' labels
    and skips read) and the forward chain's floor (a shuffle and three
    dependent add/max a frame, latencies measured on this card by
    ``viterbi_latency_probe``)."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi, kernels

    checked = 0
    for (lp, ext, skip, inp, lab), _ in calls:
        got_states, got_score = ctc_viterbi.ctc_viterbi(lp, ext, skip, inp, lab)
        for b in range(lp.shape[0]):
            emit = lp[b].cpu()[:, ext[b]]
            ws, wsc = ctc_viterbi.ctc_viterbi_plain(emit, skip[b], int(inp[b]), int(lab[b]))
            if not torch.equal(got_states[b].cpu(), ws) or got_score[b].cpu().view(torch.int32) != wsc.view(torch.int32):
                raise SystemExit(f"ctc_viterbi differs from its plain version at [T, V, S] {(*lp.shape[1:], ext.shape[1])}")
            checked += 1
    (lp, ext, skip, inp, lab), _ = max(calls, key=lambda c: c[0][0].shape[1] * c[0][1].shape[1])
    _, T, V = lp.shape
    S = ext.shape[1]
    Tv = min(max(int(inp[0]), 1), T)
    kK = lib.ctc_viterbi_states_per_thread(S)
    C = lib.ctc_viterbi_cluster_blocks(S, kK)
    meta = torch.cat([inp.int(), lab.int(), ext.int().reshape(-1), skip.int().reshape(-1)]).to(lp.device)
    back = torch.empty((1, lib.ctc_viterbi_back_words(T, S, kK, C)), dtype=torch.int32, device=lp.device)
    states = torch.empty((1, T), dtype=torch.int32, device=lp.device)
    score = torch.empty((1,), dtype=torch.float32, device=lp.device)

    def launch():
        kernels.check(lib.ctc_viterbi_launch(lp.data_ptr(), meta[2:].data_ptr(), meta[2 + S:].data_ptr(), meta.data_ptr(),
                                             meta[1:].data_ptr(), back.data_ptr(), states.data_ptr(), score.data_ptr(),
                                             1, T, S, V, kK, C, kernels.stream_ptr(lp)), "ctc_viterbi")

    ms = graph_ms(launch, reps=10)
    labels, blank = ext[0, 1::2], int(ext[0, 0])
    ctc_viterbi.ctc_forced_align(lp[0], labels, int(inp[0]), int(lab[0]), blank)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        ctc_viterbi.ctc_forced_align(lp[0], labels, int(inp[0]), int(lab[0]), blank)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / reps
    emit0, skip0 = lp[0][:, ext[0].to(lp.device)], skip[0].to(lp.device)
    plain_ms = cuda_ms(lambda: ctc_viterbi.ctc_viterbi_plain(emit0, skip0, int(inp[0]), int(lab[0])), reps=1, warmup=0)
    ptr_row = -(-2 * S // 8)  # bytes of a frame's pointers at 2 bits a state
    nbytes = Tv * V * 4 + 2 * (Tv - 1) * ptr_row + T * 4 + S * 8
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    floor = viterbi_chain_floor(lib, Tv, 2)
    chain_ms = (Tv - 1) * (floor["shfl_ns"] + 3 * floor["alu_ns"]) / 1e6
    row = dict(KERNEL_CTC, launches=pipeline_launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes", library_ms=None, check="pass", calls_checked=checked, shape_T_V_S_Tv=[T, V, S, Tv],
               states_per_thread=kK, cluster_blocks=C, chain_floor_ms=chain_ms, call_ms=call_ms)
    print(f"kernel ctc_viterbi: ms={ms:.4f} (CUDA-graph replay at [T, V] [{T}, {V}], S {S}, {Tv} frames advanced, {kK} "
          f"states a thread, {C} blocks: the pipeline's Final Transcribe) ctc_forced_align call_ms={call_ms:.4f} (host wall, "
          f"synchronised, {reps} calls) launches={pipeline_launches} bound_ms={bound:.5f} (bytes {nbytes}: log-probs "
          f"{Tv * V * 4}, 2-bit pointers written and read {2 * (Tv - 1) * ptr_row}, states {T * 4}, labels and skips "
          f"{S * 8}) chain_floor_ms={chain_ms:.4f} (({Tv} - 1) x (shfl {floor['shfl_ns']:.2f} ns + 3 x add/max "
          f"{floor['alu_ns']:.2f} ns)) plain_ms={plain_ms:.1f} max_abs_err=0 (states and score bit-equal on {checked} "
          f"captured calls) card={card}")
    return row



# ---------------------------------------------------------------------------
# the break-predictor serving path (phase 20)
# ---------------------------------------------------------------------------

# bench.py:bench_serving's vocabulary and traffic: 96 clients x 12 sentences of 6-14 words
BERT_WORDS = ("bonjour merci la maison est grande demain nous allons ensemble vers "
              "la ville et le monde entier écoute cette musique magnifique").split()
SERVE_CLIENTS, SERVE_PER_CLIENT = 96, 12
BERT_MARGIN = 0.05  # card vs CPU: a BREAK decision may differ only where the CPU margin |l1 - l0| is at most this
BERT_BATCH, BERT_ITERS, TRAIN_B = 256, 100, 64  # bench.py:bench_bert's geometry; the trainer's batch


def bert_flops_per_sentence(cfg) -> int:
    """bench.py:bert_mfu's operation count: the encoder's matmuls, the
    attention's score and value products, and the classifier."""
    d, L, ffn = cfg.hidden, cfg.max_len, cfg.ffn
    per_layer = 4 * d * d + 2 * d * ffn
    att_extra = 2 * 2 * L * d
    return 2 * L * cfg.layers * (per_layer + att_extra) + 2 * L * d * cfg.num_labels


def encode_texts(tok, texts, L: int):
    """The predictor's padding of ``texts``: ids, mask (one live token in
    every row) and the word index of each word-initial token."""
    import numpy as np

    ids = np.full((len(texts), L), tok.pad_id, np.int32)
    widx = np.full((len(texts), L), -1, np.int32)
    for i, t in enumerate(texts):
        a, w = tok.encode_words(t.split())
        ids[i, : len(a[:L])] = a[:L]
        widx[i, : len(w[:L])] = w[:L]
    mask = ids != tok.pad_id
    mask[:, 0] = True
    return ids, mask, widx


def serve_load(svc, texts, clients: int, per_client: int) -> dict:
    """bench.py:bench_serving's load: every bucket warmed, ``clients``
    keep-alive connections (Nagle off) each posting ``per_client`` sentences
    in turn to ``svc.serve(port=0)``; every response must be 200 with a
    ``<speak`` document. Returns sentences/s, p50/p99 ms and the batcher's
    stats."""
    import faulthandler
    import http.client
    import socket
    import threading

    import numpy as np
    import torch

    httpd = svc.serve(port=0)
    port = httpd.server_address[1]
    lat, bad, lock = [], [], threading.Lock()

    def client(chunk):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for t in chunk:
                t0 = time.perf_counter()
                conn.request("POST", "/ssml", json.dumps({"text": t}), {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                dt = time.perf_counter() - t0
                ok = resp.status == 200 and json.loads(body)["ssml"].startswith("<speak")
                with lock:
                    lat.append(dt)
                    if not ok:
                        bad.append((resp.status, body[:200]))
        except Exception as e:  # noqa: BLE001 — a client's failure fails the phase below
            with lock:
                bad.append(repr(e))
        finally:
            conn.close()

    try:
        for b in svc.bucket_sizes():
            svc._predict_batch(texts[:b])
        torch.cuda.synchronize()
        svc.batcher.stats.clear()
        threads = [threading.Thread(target=client, args=(texts[i * per_client : (i + 1) * per_client],), daemon=True)
                   for i in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            faulthandler.dump_traceback(all_threads=True)
            raise SystemExit("break tagger serving: clients still waiting after 300 s (every thread's stack above)")
    finally:
        httpd.shutdown()
        httpd.server_close()
    if bad or len(lat) != clients * per_client:
        raise SystemExit(f"break tagger serving: {len(bad)} bad responses of {len(lat)}: {bad[:3]}")
    lat_ms = np.asarray(lat) * 1e3
    return {"sentences_per_s": len(lat) / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall, **svc.batcher.stats.summary()}


class _TimedLosses(list):
    """A ``losses`` list for ``train_tagger`` that stamps each append: the
    trainer appends after reading the step's loss, so consecutive stamps are
    whole steps, synchronised."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def append(self, x):
        self.stamps.append(time.perf_counter())
        super().append(x)


def break_tagger_phase(card: str, seed: int, bdd_json: str, device="cuda") -> dict:
    """Phase 20 of the module docstring."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.models.bert import BertConfig, BreakTagger, SentenceEncoder
    from prosody_control_french_tts_tpu_torch.models.bilstm import BiLSTMConfig, BiLSTMProsody
    from prosody_control_french_tts_tpu_torch.models.break_trainer import sentences_per_second, train_tagger
    from prosody_control_french_tts_tpu_torch.models.datasets import BreakTagDataset
    from prosody_control_french_tts_tpu_torch.models.experiment import run_bilstm_experiment, run_break_experiment
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer
    from prosody_control_french_tts_tpu_torch.serving.predictor import SSMLPredictor

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(BERT_WORDS, size=int(rng.integers(6, 14)))) for _ in range(SERVE_CLIENTS * SERVE_PER_CLIENT)]
    tok = WordPieceTokenizer.train([" ".join(BERT_WORDS)], vocab_size=512, min_freq=1)
    cfg = BertConfig(vocab_size=max(len(tok), 512))
    flops = bert_flops_per_sentence(cfg)
    out = {}

    # (a) the card against the plain CPU path, 8 sentences as the predictor pads them
    state = BreakTagger(cfg, seed=seed, device="cpu").state_dict()
    enc_state = SentenceEncoder(cfg, seed=seed + 1, device="cpu").state_dict()
    ids, mask, widx = encode_texts(tok, texts[:8], cfg.max_len)
    res = []
    for where in ("cpu", device):
        tagger = BreakTagger(cfg, seed=None, device=where).eval()
        tagger.load_state_dict(state)
        enc = SentenceEncoder(cfg, seed=None, device=where).eval()
        enc.load_state_dict(enc_state)
        with torch.inference_mode():
            i_d, m_d = torch.from_numpy(ids).to(where), torch.from_numpy(mask).to(where)
            res.append((tagger(i_d, m_d).cpu().numpy(), enc(i_d, m_d).cpu().numpy()))
    card_tagger = tagger
    (want, emb_cpu), (got, emb_card) = res
    if not (np.isfinite(got).all() and np.isfinite(emb_card).all()):
        raise SystemExit("break tagger: non-finite outputs on the card")
    words = widx >= 0
    err = float(np.abs(got - want)[mask].max())
    agree = (got.argmax(-1) == want.argmax(-1))[words]
    margin = np.abs(want[..., 1] - want[..., 0])[words]
    cos = float(((emb_card * emb_cpu).sum(-1) / np.linalg.norm(emb_card, axis=-1) / np.linalg.norm(emb_cpu, axis=-1)).min())
    print(f"break tagger card vs CPU (hidden {cfg.hidden}, {cfg.layers} layers, {cfg.heads} heads, ffn {cfg.ffn}, vocab "
          f"{cfg.vocab_size}; 8 sentences at L {cfg.max_len}): max |logit diff| "
          f"{err:.4e}, BREAK decisions agree on {agree.mean():.4f} of {words.sum()} words (smallest CPU margin where "
          f"they differ: {float(margin[~agree].min()) if (~agree).any() else None}); sentence encoder min cosine {cos:.6f}; "
          f"card={card}")
    if (~agree & (margin > BERT_MARGIN)).any() or cos < 0.999:
        raise SystemExit(f"break tagger: card and CPU disagree where the CPU margin exceeds {BERT_MARGIN}, or the "
                         f"encoder's cosine {cos} is below 0.999")
    out["card_vs_cpu"] = {"max_abs_logit_diff": err, "decisions_agree": float(agree.mean()), "encoder_min_cos": cos}

    # (b) batched inference at bench.py's geometry
    ds = BreakTagDataset(rng.integers(5, cfg.vocab_size, size=(BERT_BATCH, cfg.max_len)).astype(np.int32),
                         np.ones((BERT_BATCH, cfg.max_len), bool), np.zeros((BERT_BATCH, cfg.max_len), np.int32))
    rate = sentences_per_second(card_tagger, None, ds, batch_size=BERT_BATCH, iters=BERT_ITERS, device=device)
    i_d, m_d = torch.as_tensor(ds.ids, device=dev), torch.as_tensor(ds.mask, device=dev)

    def forward():
        with torch.inference_mode():
            return card_tagger(i_d, m_d)

    ms_batch = cuda_ms(forward, reps=20, warmup=2)
    wall_ms, by_name = profile_device(lambda: [forward() for _ in range(10)])
    busy = sum(t for t, _ in by_name.values()) / wall_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    bound_ms = BERT_BATCH * flops / PEAK_FLOPS["bf16"] * 1e3
    share = rate * flops / PEAK_FLOPS["bf16"]
    print(f"break tagger batched inference (B {BERT_BATCH}, L {cfg.max_len}, {BERT_ITERS} forwards, one sync): "
          f"{rate:.1f} sentences/s ({share:.4f} of the {PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s dense bf16 peak at "
          f"{flops / 1e9:.3f} GFLOP a sentence, bench.py's count; bound {bound_ms:.3f} ms a batch, "
          f"{PEAK_FLOPS['bf16'] / flops:.0f} sentences/s); {ms_batch:.3f} ms a batch by CUDA events; device busy "
          f"{busy:.4f} over 10 forwards (torch.profiler, {wall_ms / 10:.3f} ms wall each); card={card}")
    print("break tagger forward, device ms over 10 forwards by kernel (top 6): "
          + json.dumps({k[:60]: [round(v[0], 3), v[1]] for k, v in top}))
    out["batched"] = {"sentences_per_s": rate, "ms_per_batch": ms_batch, "device_busy": busy, "bf16_peak_share": share,
                      "bound_ms": bound_ms}

    # (c) the HTTP service, batched and unbatched
    for label, max_batch, wait_ms in (("batched", 64, 4.0), ("unbatched", 1, 0.0)):
        svc = SSMLPredictor(tok, cfg, state, device=device, max_batch=max_batch, max_wait_ms=wait_ms)
        try:
            r = serve_load(svc, texts, SERVE_CLIENTS, SERVE_PER_CLIENT)
        finally:
            svc.close()
        print(f"break tagger HTTP serving {label} (max_batch {max_batch}, {wait_ms} ms; {SERVE_CLIENTS} clients x "
              f"{SERVE_PER_CLIENT} sentences): {r['sentences_per_s']:.1f} sentences/s, p50 {r['p50_ms']:.2f} ms, "
              f"p99 {r['p99_ms']:.2f} ms; batcher " + json.dumps({k: v for k, v in r.items() if k not in
                                                                  ("sentences_per_s", "p50_ms", "p99_ms")})
              + f"; card={card}")
        out[f"serving_{label}"] = r
    # the sequence of the one hung turn (a batched predictor closed, then an
    # unbatched one built and served), twice more in this process
    seq = []
    for _ in range(2):
        for label, max_batch, wait_ms in (("batched", 64, 4.0), ("unbatched", 1, 0.0)):
            svc = SSMLPredictor(tok, cfg, state, device=device, max_batch=max_batch, max_wait_ms=wait_ms)
            try:
                r = serve_load(svc, texts, SERVE_CLIENTS, SERVE_PER_CLIENT)
            finally:
                closed = svc.close()
            if not closed:
                raise SystemExit(f"break tagger serving ({label}): close() did not finish within its bound")
            seq.append(f"{label} {r['sentences_per_s']:.1f}/s")
    print(f"break tagger serving, batched then unbatched predictors built, served and closed twice more: "
          f"{', '.join(seq)}; every turn ended and closed; card={card}")

    # (d) the prosody head
    prosody = {"encoder_state": enc_state, "mu": [0.5, -1.0, 2.0], "sd": [3.0, 4.0, 5.0],
               "bilstm_state": BiLSTMProsody(BiLSTMConfig(embed_dim=cfg.hidden), seed=seed + 2, device="cpu").state_dict()}
    svc = SSMLPredictor(tok, cfg, state, device=device, max_batch=8, max_wait_ms=2.0, prosody=prosody)
    try:
        r = serve_load(svc, texts[:64], 8, 8)
        samples = [svc.predict(t) for t in texts[:8]]
    finally:
        svc.close()
    for sample in samples:
        if not SSML_TAG.search(sample["ssml"]) or "prosody" not in sample:
            raise SystemExit(f"break tagger: the prosody head's SSML carries no <prosody pitch/rate/volume>: {sample['ssml']}")
    sample = samples[0]
    print(f"break tagger with the prosody head: 64 requests, {r['sentences_per_s']:.1f} sentences/s, p50 "
          f"{r['p50_ms']:.2f} ms; 8 predictions, each with <prosody pitch/rate/volume>, e.g. "
          f"{json.dumps(sample['prosody'])} {sample['ssml'][:160]}...")

    # (e) the experiment drivers on the multi-voice run's bdd.json, and the trainer at bert-base width
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bdd_path = tmp / "bdd.json"
        bdd_path.write_text(bdd_json, encoding="utf-8")
        t0 = time.perf_counter()
        rep = run_break_experiment(bdd_path, tmp / "break", runs=2, epochs=2, tiny=True, device=device)
        t_break = time.perf_counter() - t0
        if not (tmp / "break" / "break_tagger.npz").exists() or not np.isfinite(rep["perplexity"]["mean"]):
            raise SystemExit(f"run_break_experiment: {rep}")
        t0 = time.perf_counter()
        reps = run_bilstm_experiment(bdd_path, tmp / "bilstm", seq_lens=(1,), epochs=2, device=device)
        t_bilstm = time.perf_counter() - t0
        if len(reps) != 1 or not np.isfinite(reps[0]["z_mse"]):
            raise SystemExit(f"run_bilstm_experiment: {reps}")
    print(f"run_break_experiment (tiny, 2 runs, 2 epochs) {t_break:.2f} s: F1 {rep['f1']['mean']:.3f}, accuracy "
          f"{rep['accuracy']['mean']:.3f}, perplexity {rep['perplexity']['mean']:.3f}, tiny tagger "
          f"{rep['sentences_per_second']:.1f} sentences/s; run_bilstm_experiment (seq_len 1, 2 epochs) {t_bilstm:.2f} s: "
          f"z MSE {reps[0]['z_mse']:.4f}, n_train {reps[0]['n_train']}; card={card}")
    n_steps = 10
    ids_t = rng.integers(5, cfg.vocab_size, size=(TRAIN_B * n_steps, cfg.max_len)).astype(np.int32)
    labels_t = rng.integers(0, 2, size=ids_t.shape).astype(np.int32)
    losses = _TimedLosses()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_tagger(BreakTagDataset(ids_t, np.ones(ids_t.shape, bool), labels_t), cfg, epochs=1, batch_size=TRAIN_B,
                 seed=seed, device=device, losses=losses)
    t_train = time.perf_counter() - t0
    if len(losses) != n_steps or not np.isfinite(losses).all():
        raise SystemExit(f"train_tagger at bert-base: losses {list(losses)}")
    step_ms = float(np.diff(losses.stamps).mean() * 1e3)
    print(f"train_tagger (hidden {cfg.hidden}, {cfg.layers} layers; B {TRAIN_B}, L {cfg.max_len}, AdamW, dropout 0.1): "
          f"{n_steps} steps, {step_ms:.2f} ms a step (steps 2-{n_steps}), {t_train:.2f} s with the model's set-up; losses "
          f"{[round(x, 4) for x in losses]}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"card={card}")
    out["train_step_ms"] = step_ms
    print(f"break tagger phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the contextual POS tagger and the evaluation layer (phase 21)
# ---------------------------------------------------------------------------

POS_MARGIN = 1e-3  # card vs CPU: a tag may differ only where the CPU's top-2 logit margin is below this
POS_GATES = {"token_acc": 0.88, "amb_acc": 0.95, "fb_acc": 0.98}  # the JAX suite's (tests/test_pos_tagger.py)
POS_TRAIN = (16000, 900, 256)  # the JAX CLI's pretrain-pos: sentences (seed 0), steps, batch
TOL_EVAL_F0 = 1e-4  # evaluate_voice card vs CPU: f0_rmse_log2
# the forms whose reading the JAX suite grades as ambiguous
POS_AMBIGUOUS = {"a", "son", "or", "car", "personne", "tout", "toute", "tous", "si", "soit", "avant", "apres", "après",
                 "pendant", "devant", "vers", "entre", "bien", "ete", "été", "pas", "leur", "en", "le", "la", "les",
                 "que", "comme", "est"}
# transcripts for the contextual pipeline: phrases where the backends read a form differently
POS_PHRASES = ("le son de la voix", "il a mangé le gâteau", "le car arrive", "cette personne parle", "or il pleut",
               "tout le monde chante", "si tu viens", "son violon sonne", "il reste car il pleut", "personne ne répond",
               "il va a paris", "le chemin est si long", "leur maison est grande", "il leur parle")


def ambiguous_transcripts(texts: list[str]) -> list[str]:
    """Each transcript's words replaced one for one by the words of
    POS_PHRASES in turn, keeping the punctuation the synth words carried (so
    the energy aligner sees as many words, and pauses fall where they did)."""
    stream = " ".join(POS_PHRASES).split()
    out, k = [], 0
    for text in texts:
        words = []
        for w in text.split():
            tail = w[len(w.rstrip(",.")):]
            words.append(stream[k % len(stream)] + tail)
            k += 1
        out.append(" ".join(words))
    return out


def pos_accuracy(tags: list, sents) -> dict:
    """The JAX suite's held-out statistics: token accuracy, accuracy on the
    ambiguous forms, and the forbidden bit's accuracy beside the lexicon's."""
    from prosody_control_french_tts_tpu_torch.models.pos_data import FORBIDDEN_TAGS
    from prosody_control_french_tts_tpu_torch.utils import fr_pos

    tot = ok = amb_tot = amb_ok = fb_ok = lex_ok = 0
    for s, pred in zip(sents, tags):
        for w, gold, p in zip(s.words, s.tags, pred):
            tot += 1
            ok += p == gold
            amb_tot += w.lower() in POS_AMBIGUOUS
            amb_ok += w.lower() in POS_AMBIGUOUS and p == gold
            fb_ok += (p in FORBIDDEN_TAGS) == (gold in FORBIDDEN_TAGS)
            lex_ok += fr_pos.is_function_word(w) == (gold in FORBIDDEN_TAGS)
    return {"token_acc": ok / tot, "amb_acc": amb_ok / amb_tot, "fb_acc": fb_ok / tot, "lexicon_fb_acc": lex_ok / tot}


def check_pos_gates(stats: dict, label: str) -> None:
    if any(stats[k] <= v for k, v in POS_GATES.items()) or stats["fb_acc"] <= stats["lexicon_fb_acc"]:
        raise SystemExit(f"{label}: held-out accuracy below the JAX suite's gates {POS_GATES}: {stats}")


def pos_tagger_phase(tmp: Path, card: str, device="cuda") -> dict:
    """Phase 21, parts 1 and 2: the packaged tagger and the trainer."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.models.pos_data import generate_treebank
    from prosody_control_french_tts_tpu_torch.models.pos_tagger import (ContextualTagger, load_tagger, save_tagger,
                                                                        train_pos_tagger)

    dev = torch.device(device)
    held = generate_treebank(800, seed=99, holdout_fillers=True)
    toks = [list(s.words) for s in held]
    card_t, cpu_t = ContextualTagger(device=dev), ContextualTagger(device="cpu")
    if max(map(len, toks)) > card_t.cfg.max_len:
        raise SystemExit("pos tagger: a held-out sentence is longer than one window")
    w, c, m = card_t.feat.encode_batch(toks)
    got, want = card_t.logits(w, c, m).cpu().numpy(), cpu_t.logits(w, c, m).numpy()
    live = m > 0
    err = float(np.abs(got - want)[live].max())
    top2 = np.sort(want, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    card_t._cache.clear()
    sync(dev)
    t0 = time.perf_counter()
    card_tags = [card_t.tag_tokens(t) for t in toks]
    tag_s = time.perf_counter() - t0
    cpu_tags = [cpu_t.tag_tokens(t) for t in toks]
    differ = [(i, j) for i, (a, b) in enumerate(zip(card_tags, cpu_tags)) for j in range(len(a)) if a[j] != b[j]]
    if any(margin[i, j] >= POS_MARGIN for i, j in differ):
        raise SystemExit(f"pos tagger: card and CPU tags differ where the CPU margin is at least {POS_MARGIN}: {differ[:5]}")
    stats = pos_accuracy(card_tags, held)
    check_pos_gates(stats, "pos tagger (packaged, card)")
    distinct = len({tuple(t) for t in toks})
    print(f"pos tagger (packaged, d_model {card_t.cfg.d_model}, {card_t.cfg.n_layers} layers) card vs CPU on {len(held)} "
          f"held-out sentences: max |logit diff| {err:.3e}, {len(differ)} tags differ, {int((live & (margin < POS_MARGIN)).sum())} "
          f"of {int(live.sum())} tokens under the {POS_MARGIN} CPU margin; held-out "
          + json.dumps({k: round(v, 4) for k, v in stats.items()})
          + f"; tag_tokens {len(toks) / tag_s:.1f} sentences/s ({len(toks)} calls, {distinct} distinct, one window a "
          f"sentence, cache cleared first); card={card}")

    n_sent, steps, batch = POS_TRAIN
    sents = generate_treebank(n_sent, seed=0)
    losses = _TimedLosses()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, feat, cfg = train_pos_tagger(sents, steps=steps, batch_size=batch, seed=0, log_every=0, device=dev,
                                        losses=losses)
    train_s = time.perf_counter() - t0
    loss = np.asarray(losses)
    if len(loss) != steps or not np.isfinite(loss).all() or not loss[-100:].mean() < 0.5 * loss[:100].mean():
        raise SystemExit(f"train_pos_tagger: losses not finite and falling: first {loss[:5]}, last {loss[-5:]}")
    step_ms = float(np.diff(losses.stamps).mean() * 1e3)
    retrained = ContextualTagger(state, feat, cfg, device=dev)
    re_tags = [retrained.tag_tokens(t) for t in toks]
    re_stats = pos_accuracy(re_tags, held)
    check_pos_gates(re_stats, "pos tagger (retrained on the card)")
    path = tmp / "pos_retrained.npz"
    save_tagger(state, feat, cfg, path)
    loaded = ContextualTagger(*load_tagger(path), device=dev)
    stored = ContextualTagger({k: v.half().float() for k, v in state.items()}, feat, cfg, device=dev)
    lo_tags = [loaded.tag_tokens(t) for t in toks]
    if lo_tags != [stored.tag_tokens(t) for t in toks]:
        raise SystemExit("pos tagger: the reloaded checkpoint tags otherwise than the weights it stored")
    moved = sum(a != b for x, y in zip(lo_tags, re_tags) for a, b in zip(x, y))
    print(f"train_pos_tagger ({n_sent} sentences, {steps} steps, B {batch}, AdamW cosine 3e-3): {step_ms:.3f} ms a step "
          f"(steps 2-{steps}, each read back), {train_s:.1f} s with set-up; loss {loss[0]:.4f} -> {loss[-1]:.4f} (mean of "
          f"the first 100 {loss[:100].mean():.4f}, the last 100 {loss[-100:].mean():.4f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; retrained held-out "
          + json.dumps({k: round(v, 4) for k, v in re_stats.items()})
          + f"; saved and reloaded: tags equal to the float16 weights it stores ({moved} tokens of "
          f"{sum(map(len, toks))} differ from the float32 ones); card={card}")
    return {"sentences_per_s": len(toks) / tag_s, "logit_err": err, "stats": stats, "train_step_ms": step_ms,
            "retrained": re_stats}


def pauses_and_commas(pipe) -> dict:
    """Per segment: pause rows and commas in the syntagme text of
    BDD_syntagme_ssml.csv."""
    out: dict = {}
    for r in read_csv(pipe.bdd_syntagme_ssml_csv):
        p, c = out.get(r["segment"], (0, 0))
        out[r["segment"]] = (p + (not r["syntagme"].strip() and float(r["pause"]) > 0), c + r["syntagme"].count(","))
    return out


def contextual_pipeline_phase(tmp: Path, seed: int, card: str, device="cuda") -> tuple:
    """Phase 21, part 3. Returns (the voice's base directory, its name, the
    warm run's audio-s/s, its device-busy share)."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import candidates, viterbi

    dev = torch.device(device)
    name, base, lex_base = "ctx_voice", tmp / "pos_pipeline", tmp / "pos_pipeline_lexicon"
    texts, audio_s = build_brute_voice(base, name, seed, FULL_SEGMENTS)
    build_brute_voice(lex_base, name, seed, FULL_SEGMENTS)
    texts = ambiguous_transcripts(texts)
    pipe, cold, cold_s = drive_voice(base, name, texts, dev, "contextual")
    reset_kernel_counts()
    with Capture(candidates, "topk_parabolic") as cap_a, Capture(viterbi, "viterbi_path") as cap_b:
        warm, warm_s = run_steps(pipe, None)
    counts = kernel_counts()
    if counts["pitch_candidates"] != 1 or counts["viterbi"] != 1 or counts["frames"] or counts["chunk_cumsum"] \
            or counts["mask_ema"]:
        raise SystemExit(f"contextual pipeline: A and B once each and no other kernel, got {counts}")
    check_a_b(cap_a.calls, cap_b.calls, "contextual pipeline, warm run")
    check_pipeline_artifacts(pipe, FULL_SEGMENTS)
    trace = profile_measure(lambda: pipe.run())
    lex, _, _ = drive_voice(lex_base, name, texts, dev, "lexicon")
    ctx_pc, lex_pc = pauses_and_commas(pipe), pauses_and_commas(lex)
    more = {k: sum(max(0, ctx_pc.get(s, (0, 0))[i] - lex_pc.get(s, (0, 0))[i]) for s in ctx_pc.keys() | lex_pc.keys())
            for i, k in enumerate(("pauses", "commas"))}
    fewer = {k: sum(max(0, lex_pc.get(s, (0, 0))[i] - ctx_pc.get(s, (0, 0))[i]) for s in ctx_pc.keys() | lex_pc.keys())
             for i, k in enumerate(("pauses", "commas"))}
    print(f"contextual pipeline ({FULL_SEGMENTS} segments, {audio_s:.1f} s, transcripts of ambiguous forms) warm run "
          f"launches: {json.dumps(counts)}; against a lexicon run on the same recording and transcripts: the contextual "
          f"backend keeps {json.dumps(more)} that the lexicon drops and drops {json.dumps(fewer)} that it keeps "
          f"(pause rows and syntagme commas of BDD_syntagme_ssml.csv, per segment)")
    small_voice_card_vs_cpu(tmp / "pos_pipeline_small", seed + 1, dev, "contextual pipeline small voice", "contextual",
                            ambiguous_transcripts)
    print(f"contextual pipeline eight steps (warm): {warm_s:.3f} s, {audio_s / warm_s:.1f} audio-s/s, device busy "
          f"{trace['device_busy_share']:.4f} (torch.profiler, a third run); cold {cold_s:.3f} s, {audio_s / cold_s:.1f} "
          f"audio-s/s; card={card}")
    print("contextual pipeline steps warm (s): " + json.dumps(per_step(warm)))
    print("contextual pipeline steps cold (s): " + json.dumps(per_step(cold)))
    return base, name, audio_s / warm_s, trace["device_busy_share"]


def eval_layer_phase(tmp: Path, card: str, mv_base: Path, ctx_base: Path, ctx_name: str, device="cuda") -> dict:
    """Phase 21, part 4: the evaluation layer on the pipelines' outputs."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.align.synth_speech import sample_sentences, synth_sentence
    from prosody_control_french_tts_tpu_torch.eval import corpus_compare, metrics, real_audio_agreement, yin
    from prosody_control_french_tts_tpu_torch.eval.evaluate_voice import evaluate_all, evaluate_voice
    from prosody_control_french_tts_tpu_torch.ops import candidates, ctc_viterbi, dtw, viterbi
    from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams, praat_pitch
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio, read_wav, write_wav

    dev = torch.device(device)
    evaluated_s = 0.0
    for b in (mv_base, ctx_base):
        for v in (b / "Data" / "voice").iterdir():
            if (b / "Out" / "results" / v.name).is_dir():
                evaluated_s += min(120.0, sum(read_wav(p).duration_seconds for p in (v / "audio").glob("segment_ph*.wav")))
    torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    with (Capture(dtw, "_cost_matrix", results=False) as cap, Timed(metrics, "f0_contour") as t_yin,
          Timed(metrics, "dtw_path") as t_dtw):
        voices = {**evaluate_all(mv_base / "Out", mv_base / "Data" / "voice", device=dev)["voices"],
                  **evaluate_all(ctx_base / "Out", ctx_base / "Data" / "voice", device=dev)["voices"]}
    sync(dev)
    eval_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shapes = [(int(a[0].shape[0]), int(a[1].shape[0])) for a, _ in cap.calls]
    bad = {n: r for n, r in voices.items() if "error" in r or not {"f0_rmse_log2", "break", "wer"} <= set(r)}
    n_voices = sum(1 for b in (mv_base, ctx_base) for v in (b / "Out" / "results").iterdir() if v.is_dir())
    if len(voices) != n_voices or bad:
        raise SystemExit(f"evaluate_all: {len(voices)} voices, failed or incomplete: {bad}")
    cpu = evaluate_voice(ctx_base / "Out" / "results" / ctx_name, ctx_base / "Data" / "voice" / ctx_name, device="cpu")
    card_r = voices[ctx_name]
    f0_diff = abs(cpu["f0_rmse_log2"] - card_r["f0_rmse_log2"])
    if cpu["break"] != card_r["break"] or cpu["wer"] != card_r["wer"] or f0_diff > TOL_EVAL_F0:
        raise SystemExit(f"evaluate_voice {ctx_name}: card {card_r} vs CPU {cpu}")
    print("evaluate_all (phase 15's four voices and the contextual voice; the first 120 s of each): "
          + json.dumps({n: {"f0_rmse_log2": round(r["f0_rmse_log2"], 4), "break_f1": round(r["break"]["f1"], 4),
                            "wer": round(r["wer"], 4)} for n, r in sorted(voices.items())})
          + f"; no voice in error; {eval_s:.2f} s for {evaluated_s:.1f} s of natural audio ({eval_s / evaluated_s:.2e} s "
          f"per audio-s; YIN contours on the host {t_yin.seconds:.2f} s, the DTW {t_dtw.seconds:.2f} s with its path's "
          f"read-back and backtrack, the rest reading and merging wavs); DTW cost matrices {shapes}, peak device memory "
          f"{peak / 2**20:.1f} MiB; {ctx_name} on the CPU: "
          f"break F1 and WER equal, f0_rmse_log2 |diff| {f0_diff:.2e} (limit {TOL_EVAL_F0}); card={card}")

    seg_dirs = [mv_base / "Data" / "voice" / name / "audio" for name, _, _ in MULTI_VOICES]
    wavs = [p for d in seg_dirs for p in d.glob("*.wav")]
    seg_s = sum(read_wav(p).duration_seconds for p in wavs)
    reset_kernel_counts()
    sync(dev)
    t0 = time.perf_counter()
    with Capture(candidates, "topk_parabolic") as cap_a, Capture(viterbi, "viterbi_path") as cap_b:
        feats = [corpus_compare.extract_features(d, device=dev) for d in seg_dirs]
        sync(dev)
    feat_s = time.perf_counter() - t0
    counts = kernel_counts()
    if counts["pitch_candidates"] != len(wavs) or counts["viterbi"] != len(wavs):
        raise SystemExit(f"extract_features: A and B must launch once per wav ({len(wavs)}), got {counts}")
    check_a_b(cap_a.calls, cap_b.calls, "extract_features, 75 Hz floor")
    pitch = np.concatenate([f["pitch_mean"] for f in feats])
    loud = np.concatenate([f["loudness_dbfs"] for f in feats])
    if pitch.size != len(wavs) or not (pitch > 0).all() or not np.isfinite(loud).all():
        raise SystemExit(f"extract_features: pitch {pitch}, loudness {loud}")
    print(f"extract_features over phase 15's {len(wavs)} segments ({seg_s:.1f} s): A {counts['pitch_candidates']} and B "
          f"{counts['viterbi']} launches, {feat_s:.3f} s ({feat_s / seg_s:.2e} s per audio-s); mean pitch "
          f"{pitch.min():.1f}-{pitch.max():.1f} Hz, loudness {loud.min():.2f}-{loud.max():.2f} dBFS; card={card}")

    seg = read_wav(wavs[0]).to_mono()
    x = np.asarray(seg.samples, np.float32)
    with Capture(candidates, "topk_parabolic") as cap_a, Capture(viterbi, "viterbi_path") as cap_b:
        bf = metrics.f0_contour(x, seg.rate, method="boersma", device=dev)
        bt = praat_pitch(x, seg.rate, PitchParams(floor=60.0, ceiling=600.0), device=dev).times
    check_a_b(cap_a.calls, cap_b.calls, "f0_contour(method='boersma'), 60 Hz floor")
    yf, yt = yin.yin_f0(x, seg.rate)
    agree = yin.cross_method_agreement(yf, yt, bf, bt)
    if "median_abs_cents" not in agree:
        raise SystemExit(f"cross_method_agreement on {wavs[0].name}: no frame voiced by both: {agree}")
    print(f"YIN against f0_contour(method='boersma') on {wavs[0].parent.parent.name}/{wavs[0].name} "
          f"({seg.duration_seconds:.1f} s): " + json.dumps({k: round(v, 4) for k, v in agree.items()}))

    clip_dir = tmp / "agreement_clips"
    clip_dir.mkdir()
    refs, clips = {}, []
    for i, sent in enumerate(sample_sentences(8, seed=555_000)[:3]):
        clips.append(clip_dir / f"clip{i}.wav")
        write_wav(clips[-1], Audio(synth_sentence(sent, seed=555_000 + i)[0], 16000))
        refs[f"clip{i}"] = sent
    ctc_viterbi.launches = 0
    t0 = time.perf_counter()
    rep = real_audio_agreement.corpus_agreement_report(clips, refs, device=dev)
    agree_s = time.perf_counter() - t0
    empty = [k for k, v in rep["summary"].items() if v is None]
    if ctc_viterbi.launches != len(clips) or empty:
        raise SystemExit(f"corpus_agreement_report: ctc_viterbi {ctc_viterbi.launches} launches for {len(clips)} clips, "
                         f"empty fields {empty}")
    print(f"corpus_agreement_report on {len(clips)} synthetic clips (phase 16's held-out sentences, seed 555000): "
          f"ctc_viterbi {ctc_viterbi.launches} launches, {agree_s:.2f} s; " + json.dumps(rep["summary"]) + f"; card={card}")
    return {"eval_s_per_audio_s": eval_s / evaluated_s, "features_s_per_audio_s": feat_s / seg_s,
            "dtw_shapes": shapes, "peak_mib": peak / 2**20}


def pos_eval_phase(tmp: Path, seed: int, card: str, mv_base: Path, device="cuda") -> dict:
    """Phase 21 of the module docstring."""
    t0 = time.perf_counter()
    out = pos_tagger_phase(tmp, card, device)
    ctx_base, ctx_name, out["pipeline_audio_s_per_s"], out["pipeline_busy"] = contextual_pipeline_phase(
        tmp, seed, card, device)
    out.update(eval_layer_phase(tmp, card, mv_base, ctx_base, ctx_name, device))
    print(f"pos tagger and evaluation phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the training halves of the aligners and the separator (phase 22)
# ---------------------------------------------------------------------------

# not a TPU kernel: the CTC loss's lax.scan and JAX's autodiff of it
KERNEL_CTC_LOSS = dict(
    name="ctc_loss",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/ctc_loss.cu",
    replaces="prosody_control_french_tts_tpu/align/ctc.py:95",
)
# ctc_loss vs plain: the same float32 recursion, exp and log1p maybe a bit
# apart; the rounding of alpha grows with its size (about the loss)
TOL_CTC_LOSS = 1e-5  # loss, relative
TOL_CTC_LOSS_GRAD = 1e-5  # gradient: x max(1, loss / 100) absolute; x its largest entry when infeasible
# operations a state a frame (float32, for the operations bound): the forward's
# two logaddexp (sub, abs, neg, exp, log1p, max, add each) and the add; the
# backward's recomputed logaddexp, four subtracts, four exps, five multiplies
# and two adds
CTC_LOSS_OPS = {"fwd": 15, "bwd": 29}
TRAIN_CTC_SEGMENTS, TRAIN_CTC_EPOCHS = 12, 3  # phase 22's per-project corpus: segments of up to 19.5 s
WHISPER_CUT = dict(n_sentences=192, epochs=2)  # the Whisper recipe in phase 22 (full: tools/aligner_training_phase.py)


class StepClock:
    """Wrap a recipe's step factory (``owner.name``, a module function or a
    class's method): CUDA events recorded around each step it makes (no
    synchronise), so ``ms_per_step(skip)`` reads the stream's time from the
    end of step ``skip`` (the first step's start for 0) to the last step's
    end over the steps between, host gaps included."""

    def __init__(self, owner, name):
        self.owner, self.name, self.orig = owner, name, getattr(owner, name)
        self.events = []

    @property
    def steps(self) -> int:
        return len(self.events) - 1

    def _event(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        orig = self.orig

        def factory(*a, **k):
            step = orig(*a, **k)

            def timed(*sa, **sk):
                if not self.events:
                    self.events.append(self._event())
                r = step(*sa, **sk)
                self.events.append(self._event())
                return r

            return timed

        setattr(self.owner, self.name, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    def ms_per_step(self, skip: int = 0) -> float:
        self.events[-1].synchronize()
        return self.events[skip].elapsed_time(self.events[-1]) / (self.steps - skip)


class CtcLossCapture:
    """Wrap ``ctc_aligner.ctc_loss`` (what the train step calls) to keep a
    detached copy of each call's inputs."""

    def __init__(self):
        from prosody_control_french_tts_tpu_torch.align import ctc_aligner

        self.module, self.orig, self.calls = ctc_aligner, ctc_aligner.ctc_loss, []

    def __enter__(self):
        def wrapper(lp, labels, input_len, label_len, blank=0):
            self.calls.append((lp.detach().clone(), list(labels), int(input_len), int(label_len)))
            return self.orig(lp, labels, input_len, label_len, blank=blank)

        self.module.ctc_loss = wrapper
        return self

    def __exit__(self, *exc):
        self.module.ctc_loss = self.orig


def ctc_loss_pair(lp, labels, inp: int, lab: int):
    """(kernel loss, kernel grad, plain loss, plain grad) on the card."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import ctc_loss

    got_lp = lp.detach().clone().requires_grad_(True)
    got = ctc_loss.ctc_loss(got_lp, torch.as_tensor(labels), inp, lab)
    got.backward()
    want_lp = lp.detach().clone().requires_grad_(True)
    want = ctc_loss.ctc_loss_plain(want_lp, torch.as_tensor(labels).to(lp.device), inp, lab)
    want.backward()
    return float(got), got_lp.grad, float(want), want_lp.grad


def check_ctc_loss(lp, labels, inp: int, lab: int, label: str) -> tuple[float, float]:
    """ctc_loss against its plain version: (relative loss error, gradient
    error over its limit's scale)."""
    g, gg, w, wg = ctc_loss_pair(lp, labels, inp, lab)
    rel = abs(g - w) / max(abs(w), 1e-30)
    scale = max(1.0, float(wg.abs().max())) if w > 1e29 else max(1.0, abs(w) / 100.0)
    gerr = float((gg - wg).abs().max()) / scale
    if not (rel <= TOL_CTC_LOSS and gerr <= TOL_CTC_LOSS_GRAD):
        raise SystemExit(f"ctc_loss differs from its plain version ({label}): loss {g} vs {w} (rel {rel:.2e}), "
                         f"gradient error {gerr:.2e} of its scale")
    return rel, gerr


def ctc_loss_edge_cases(dev) -> int:
    """ctc_loss against plain at label_len 0 and 1, input_len < T, repeated
    labels, an infeasible alignment, one frame, S at the kernel's limit
    (4,095), and one past it (which must raise)."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.ops import ctc_loss

    cases = [(40, 10, 5, 40, 0, None), (40, 10, 5, 40, 1, None), (1000, 47, 300, 700, 250, None),
             (30, 5, 6, 30, 6, [1, 1, 2, 2, 1, 1]), (10, 10, 15, 10, 15, None), (9, 6, 3, 1, 2, None),
             (1100, 48, 512, 1100, 512, None), (2200, 48, 1024, 2200, 1024, None), (4200, 48, 2047, 4200, 2047, None)]
    for T, V, L, inp, lab, labels in cases:
        rng = np.random.default_rng(T + L)
        x = rng.standard_normal((T, V)).astype(np.float32) * 3.0
        lp = torch.from_numpy((x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)).to(dev)
        lab_list = labels if labels is not None else rng.integers(1, V, L).tolist()
        check_ctc_loss(lp, lab_list, inp, lab, f"edge T {T} V {V} L {L} input_len {inp} label_len {lab}")
    lp = torch.zeros((4200, 48), device=dev)
    try:
        ctc_loss.ctc_loss(lp, list(range(1, 48)) * 43 + [1] * 27, 4200, 2048)
    except ValueError as e:
        if "4096" not in str(e):
            raise
    else:
        raise SystemExit("ctc_loss took 4,097 states")
    return len(cases)


def ctc_loss_row(calls, launches: int, edge_cases: int, card: str, lib) -> dict:
    """ctc_loss timed at the largest captured train_ctc call: the forward and
    the backward launches alone as CUDA-graph replays, the plain version
    (forward loop, backward loop) and F.ctc_loss(reduction="sum") forward and
    backward on the same inputs, the bytes and operations bound and each
    launch's chain floor."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from prosody_control_french_tts_tpu_torch.ops import ctc_loss, kernels

    lp, labels, inp, lab = max(calls, key=lambda c: c[0].shape[0] * len(c[1]))
    dev = lp.device
    T, V = lp.shape
    S = 2 * len(labels) + 1
    Tv = min(max(inp, 1), T)
    ext, skip = ctc_loss._states(torch.as_tensor(labels), 0)
    col_ptr, col_states = ctc_loss._column_lists(ext, V)
    meta = torch.cat([ext.int(), skip.int(), col_ptr, col_states]).to(dev)
    alpha = torch.empty((T, S), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    go = torch.ones((), dtype=torch.float32, device=dev)
    dlogp = torch.empty((T, V), dtype=torch.float32, device=dev)
    de = torch.empty((Tv, S), dtype=torch.float32, device=dev)

    def fwd():  # on the current stream: a graph capture runs it on its own
        kernels.check(lib.ctc_loss_fwd_launch(lp.data_ptr(), meta.data_ptr(), meta[S:].data_ptr(), alpha.data_ptr(),
                                              loss.data_ptr(), T, S, V, Tv, lab, kernels.stream_ptr(lp)), "ctc_loss_fwd")

    def bwd():
        kernels.check(lib.ctc_loss_bwd_launch(alpha.data_ptr(), meta[S:].data_ptr(), meta[2 * S:].data_ptr(),
                                              meta[2 * S + V + 1:].data_ptr(), go.data_ptr(), de.data_ptr(),
                                              dlogp.data_ptr(), T, S, V, Tv, lab, kernels.stream_ptr(lp)), "ctc_loss_bwd")

    fwd()
    ms_f = graph_ms(fwd, reps=10)
    ms_b = graph_ms(bwd, reps=10)
    emit, skip_d = lp[:, ext.to(dev)], skip.to(dev)
    plain_f = cuda_ms(lambda: ctc_loss.ctc_loss_forward_plain(emit, skip_d, inp, lab), reps=1, warmup=1)
    a_plain, _ = ctc_loss.ctc_loss_forward_plain(emit, skip_d, inp, lab)
    plain_b = cuda_ms(lambda: ctc_loss.ctc_loss_backward_plain(a_plain, ext, skip_d, T, V, lab, go), reps=1, warmup=1)
    lab_t = torch.as_tensor(labels, device=dev)[None]
    il, tl = torch.tensor([inp], device=dev), torch.tensor([lab], device=dev)
    lib_f = cuda_ms(lambda: F.ctc_loss(lp[:, None], lab_t, il, tl, reduction="sum"), reps=10, warmup=2)
    lp_g = lp.detach().clone().requires_grad_(True)

    def lib_fb():
        F.ctc_loss(lp_g[:, None], lab_t, il, tl, reduction="sum").backward()

    lib_b = max(cuda_ms(lib_fb, reps=10, warmup=2) - lib_f, 0.0)
    out = torch.empty(1, device=dev)
    steps = 100_000
    step_ns = cuda_ms(lambda: kernels.check(lib.ctc_loss_latency_probe(out.data_ptr(), steps, kernels.stream_ptr(lp)),
                                            "ctc_loss_latency_probe"), reps=3) * 1e6 / steps
    alu_ns = alu_latency_ns(lib)
    floor_f = (Tv - 1) * step_ns / 1e6
    floor_b = (Tv - 1) * 3 * alu_ns / 1e6
    bytes_f, bytes_b = T * V * 4 + len(labels) * 4 + 4, T * V * 4 + 4
    ops_f, ops_b = (Tv - 1) * S * CTC_LOSS_OPS["fwd"], (Tv - 1) * S * CTC_LOSS_OPS["bwd"]
    bound_f = max(bytes_f / HBM_BYTES_PER_S, ops_f / PEAK_FLOPS["f32"]) * 1e3
    bound_b = max(bytes_b / HBM_BYTES_PER_S, ops_b / PEAK_FLOPS["f32"]) * 1e3
    by = "operations" if ops_f / PEAK_FLOPS["f32"] > bytes_f / HBM_BYTES_PER_S else "bytes"
    row = dict(KERNEL_CTC_LOSS, launches=launches, max_abs_err=0.0, ms=ms_f + ms_b, plain_ms=plain_f + plain_b,
               bound_ms=bound_f + bound_b, bound_by=by, library_ms=lib_f + lib_b, check="pass",
               ms_fwd=ms_f, ms_bwd=ms_b, plain_ms_fwd=plain_f, plain_ms_bwd=plain_b, library_ms_fwd=lib_f,
               library_ms_bwd=lib_b, bound_ms_fwd=bound_f, bound_ms_bwd=bound_b, chain_floor_ms_fwd=floor_f,
               chain_floor_ms_bwd=floor_b, shape_T_V_S_Tv=[T, V, S, Tv], calls_checked=len(calls),
               edge_cases_checked=edge_cases, states_per_thread=lib.ctc_loss_states_per_thread(S))
    print(f"kernel ctc_loss: ms={ms_f + ms_b:.4f} (forward {ms_f:.4f} + backward {ms_b:.4f}, CUDA-graph replays at "
          f"[T, V] [{T}, {V}], S {S}, {Tv} frames: the largest train_ctc step of phase 22) launches={launches} "
          f"bound_ms={bound_f + bound_b:.6f} ({by}: forward {bytes_f} bytes, {ops_f} float32 operations; backward "
          f"{bytes_b} bytes, {ops_b} operations) chain_floor_ms forward {floor_f:.4f} (({Tv} - 1) x {step_ns:.2f} ns, "
          f"one state's step measured by ctc_loss_latency_probe) backward {floor_b:.4f} (({Tv} - 1) x 3 x "
          f"{alu_ns:.2f} ns) plain_ms={plain_f + plain_b:.1f} (forward {plain_f:.1f}, backward {plain_b:.1f}) "
          f"library_ms={lib_f + lib_b:.4f} (F.ctc_loss sum: forward {lib_f:.4f}, backward {lib_b:.4f}) "
          f"max_abs_err within limits on {len(calls)} captured calls and {edge_cases} edge cases card={card}")
    return row


def write_sentence_voice(base: Path, name: str, n_segments: int, seed: int, max_s: float = 19.5):
    """A voice directory of synthetic French: segment_ph<i>.wav (sentences
    0.3 s apart, as many as fit in ``max_s``, under train_ctc's 20 s cap;
    16 kHz) with its transcription/segment_ph<i>.txt, as the pipeline leaves
    them for ``build_natural_corpus``."""
    import numpy as np

    from prosody_control_french_tts_tpu_torch.align.synth_speech import SynthSpec, sample_sentences, synth_sentence
    from prosody_control_french_tts_tpu_torch.utils.wavio import write_wav

    spec = SynthSpec()
    sents = iter(enumerate(sample_sentences(20 * n_segments, seed=seed)))
    gap = np.zeros(int(0.3 * spec.sample_rate), np.float32)
    (base / name / "audio").mkdir(parents=True, exist_ok=True)
    (base / name / "transcription").mkdir(parents=True, exist_ok=True)
    pending = None
    for i in range(n_segments):
        parts, words, n = [], [], 0
        while True:
            j, s = pending or next(sents)
            pending = None
            x = synth_sentence(s, spec, seed=seed + j)[0]
            if words and n + x.size + gap.size > max_s * spec.sample_rate:
                pending = (j, s)
                break
            parts += [x, gap]
            words.append(s)
            n += x.size + gap.size
        write_wav(base / name / "audio" / f"segment_ph{i + 1}.wav", np.concatenate(parts), spec.sample_rate)
        (base / name / "transcription" / f"segment_ph{i + 1}.txt").write_text(" ".join(words), encoding="utf-8")


def train_ctc_card_vs_cpu(corpus: Path, dev) -> dict:
    """One train_ctc step from the same initialisation on the card and on
    the CPU, on the card's first mel: the losses, and the updated weights
    (Adam's first step moves each weight by about lr, so an element whose
    tiny gradient changed sign moves the other way: the share of such
    elements and the largest difference are read)."""
    import torch

    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner
    from prosody_control_french_tts_tpu_torch.align.train_ctc import load_pairs

    lr = 3e-4
    a, text = load_pairs(corpus)[0]
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        al = CTCAligner(device=device)
        al.init_params(0)
        step = al.make_train_step(lr=lr)
        mel = al.features(a)
        labels = al.vocab.encode(" ".join(text.split()))
        out[name] = (float(step(mel, mel.shape[0] // 2, labels, len(labels))),
                     {k: v.detach().cpu() for k, v in al.model.state_dict().items()})
    rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    diffs = [(out["card"][1][k] - out["cpu"][1][k]).abs() for k in out["cpu"][1]]
    worst = max(float(d.max()) for d in diffs)
    flipped = sum(int((d > lr).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    if not (rel <= 1e-3 and worst <= 2.5 * lr and flipped <= 0.05):
        raise SystemExit(f"train_ctc first step card vs CPU: loss rel {rel:.2e}, weights max |diff| {worst:.2e}, "
                         f"share moved the other way {flipped:.4f}")
    return dict(loss_card=out["card"][0], loss_cpu=out["cpu"][0], loss_rel=rel, weights_max_diff=worst,
                share_flipped=flipped)


def aligner_training_phase(card: str, lib, seed: int = 0) -> dict:
    """Phase 22: the training halves of the aligners and the separator on the
    card. ``train_ctc_aligner`` at the default geometry on a corpus of
    synthetic French segments built by ``build_natural_corpus`` (ctc_loss
    counted, every call held to the plain version, edge cases, timing),
    ``pretrain_ctc.pretrain`` and ``pretrain_masknet`` as the recipes stand
    (gates on), ``pretrain_whisper.pretrain`` cut to ``WHISPER_CUT`` (gates
    printed). Every checkpoint goes to a temporary directory."""
    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.align import pretrain_ctc, pretrain_whisper
    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner
    from prosody_control_french_tts_tpu_torch.align.train_ctc import load_pairs, train_ctc_aligner
    from prosody_control_french_tts_tpu_torch.audio import separate
    from prosody_control_french_tts_tpu_torch.audio.corpus import build_natural_corpus
    from prosody_control_french_tts_tpu_torch.audio.separate import pretrain_masknet
    from prosody_control_french_tts_tpu_torch.ops import ctc_loss

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_sentence_voice(tmp / "data", "synth-fr", TRAIN_CTC_SEGMENTS, seed + 4242)
        n_pairs = build_natural_corpus(tmp / "data", tmp / "corpus")
        if n_pairs != TRAIN_CTC_SEGMENTS:
            raise SystemExit(f"build_natural_corpus: {n_pairs} pairs for {TRAIN_CTC_SEGMENTS} segments")
        seconds = sum(a.duration_seconds for a, _ in load_pairs(tmp / "corpus"))
        ctc_loss.launches = 0
        with CtcLossCapture() as cap, StepClock(CTCAligner, "make_train_step") as clock:
            t0 = time.perf_counter()
            al, losses = train_ctc_aligner(tmp / "corpus", tmp / "ctc.npz", epochs=TRAIN_CTC_EPOCHS, seed=seed)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        launches = ctc_loss.launches
        steps = TRAIN_CTC_EPOCHS * TRAIN_CTC_SEGMENTS
        if launches != 2 * steps or len(cap.calls) != steps:
            raise SystemExit(f"train_ctc: {launches} ctc_loss launches and {len(cap.calls)} calls for {steps} steps")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"train_ctc: losses {losses}")
        al2 = CTCAligner(weights_path=tmp / "ctc.npz")
        a, text = load_pairs(tmp / "corpus")[0]
        words = [iv.mark for iv in al2.align(a, text).tiers[0] if iv.mark.strip()]
        if words != text.split():
            raise SystemExit(f"train_ctc: the reloaded checkpoint aligned {len(words)} of {len(text.split())} words")
        cvc = train_ctc_card_vs_cpu(tmp / "corpus", dev)
        worst = [0.0, 0.0]
        for lp, labels, inp, lab in cap.calls:
            rel, gerr = check_ctc_loss(lp, labels, inp, lab, "captured train_ctc step")
            worst = [max(worst[0], rel), max(worst[1], gerr)]
        n_edge = ctc_loss_edge_cases(dev)
        row = ctc_loss_row(cap.calls, launches, n_edge, card, lib)
        row["max_abs_err"] = worst[1]
        shapes = [(c[0].shape[0], 2 * len(c[1]) + 1) for c in cap.calls]
        print(f"train_ctc (phase 22): {TRAIN_CTC_SEGMENTS} segments of synthetic sentences ({seconds:.1f} s), "
              f"{TRAIN_CTC_EPOCHS} epochs at the default geometry: {train_s:.3f} s (features included), "
              f"{clock.ms_per_step(TRAIN_CTC_SEGMENTS):.2f} ms a step after the first epoch ({clock.ms_per_step():.2f} "
              f"with it: each new length's first convolutions and products are set up then; CUDA events), losses {[round(x, 3) for x in losses]}; ctc_loss launches "
              f"{launches} = 2 x {steps} steps; [T, S] from {min(shapes)} to {max(shapes)}; held to plain: loss "
              f"rel {worst[0]:.2e}, gradient {worst[1]:.2e} of its scale; the reloaded checkpoint aligned every "
              f"word; first step card vs CPU: loss {cvc['loss_card']:.5f} vs {cvc['loss_cpu']:.5f} (rel "
              f"{cvc['loss_rel']:.2e}), weights max |diff| {cvc['weights_max_diff']:.2e}, share moved the other "
              f"way {cvc['share_flipped']:.5f}; card={card}")
        row["train_ctc_ms_per_step"] = clock.ms_per_step(TRAIN_CTC_SEGMENTS)
        out["ctc_loss_row"] = row

        t0 = time.perf_counter()
        with StepClock(pretrain_ctc, "_make_step") as clock:
            al_c, err_ms = pretrain_ctc.pretrain(tmp / "ctc_fr_synth.npz", seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"pretrain_ctc (phase 22): 384 sentences, 12 epochs, B 8, gate on: wall {wall:.1f} s, "
              f"{clock.steps} steps at {clock.ms_per_step():.2f} ms a step (CUDA events), held-out boundary error "
              f"{err_ms:.2f} ms (gate 60); card={card}")
        out["pretrain_ctc"] = dict(wall_s=wall, boundary_ms=err_ms, ms_per_step=clock.ms_per_step())

        t0 = time.perf_counter()
        with StepClock(separate, "_make_step") as clock:
            sep, gain = pretrain_masknet(tmp / "masknet.npz", seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"pretrain_masknet (phase 22): 256 mixtures, 10 epochs, B 4, gates on: wall {wall:.1f} s, "
              f"{clock.steps} steps at {clock.ms_per_step():.2f} ms a step (CUDA events), losses "
              f"{[round(x, 5) for x in sep.losses]}, held-out SI-SNR gain {gain:.2f} dB (gate 5); real-mixture gate "
              f"{'ran: %.2f dB' % sep.real_gain if np.isfinite(sep.real_gain) else 'did not run (no real corpus)'}; "
              f"card={card}")
        out["pretrain_masknet"] = dict(wall_s=wall, si_snr_gain_db=gain, real_gain_db=sep.real_gain,
                                       ms_per_step=clock.ms_per_step())

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StepClock(pretrain_whisper, "_make_step") as clock:
            al_w, err_w, acc_w = pretrain_whisper.pretrain(tmp / "whisper", seed=seed,
                                                          target_boundary_ms=float("inf"), target_word_acc=0.0,
                                                          target_formant_word_acc=0.0, **WHISPER_CUT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"pretrain_whisper (phase 22, cut to {WHISPER_CUT['n_sentences']} sentences, {WHISPER_CUT['epochs']} "
              f"epochs, B 16, synth_fr_config): wall {wall:.1f} s, {clock.steps} steps at {clock.ms_per_step():.2f} "
              f"ms a step (CUDA events), peak device memory {peak:.2f} GiB, epochs (ce, att) "
              f"{[(round(c, 4), round(a_, 4)) for c, a_ in al_w.history]}; gates read, not asserted: {al_w.gates}; "
              f"card={card}")
        out["pretrain_whisper_cut"] = dict(wall_s=wall, peak_gib=peak, history=al_w.history, gates=al_w.gates,
                                           ms_per_step=clock.ms_per_step())
    phase_s = time.perf_counter() - t_phase
    print(f"phase 22 took {phase_s:.1f} s; card={card}")
    out["phase_s"] = phase_s
    return out


# ---------------------------------------------------------------------------
# phase 23: the umbrella command line and the host front ends on the card
# ---------------------------------------------------------------------------

CLI_VOICE, LEGACY_VOICE = "cli_voice", "legacy_voice"
TOL_LEGACY_CARD_CPU = 0.05  # legacy adjustments card vs CPU, points (the pipeline's card-vs-CPU limit)
# plot data card vs CPU, on the unrounded spectrogram (``ops.stft.spectrogram``, n_fft 1024, hop 256):
# amplitude within 1e-5 of the peak amplitude everywhere (fifty times the 2e-7 by which the CPU's
# float32 spectrogram of a cli voice segment departs from its float64 one), dB within 1e-3 where the
# power is within 40 dB of the peak (float32 there: 2e-5 dB); F0 relative where both voiced
TOL_VIZ_AMP, TOL_VIZ_DB, TOL_VIZ_DB_RANGE, TOL_VIZ_F0 = 1e-5, 1e-3, 40.0, 0.01
# Qwen/Qwen2.5-7B config.json, and openai/whisper-base's
QWEN25_7B_HF = dict(vocab_size=152064, hidden_size=3584, num_hidden_layers=28, num_attention_heads=28,
                    num_key_value_heads=4, intermediate_size=18944, rope_theta=1e6)
WHISPER_BASE_HF = dict(d_model=512, encoder_layers=6, decoder_layers=6, heads=8, num_mel_bins=80, vocab_size=51865,
                       ffn=2048, max_source_positions=1500, max_target_positions=448)
CLI_NEW_TOKENS = 8


def cli(argv) -> float:
    """One ``python -m prosody_control_french_tts_tpu_torch`` command in this
    process → wall seconds to the end of the device's work; a non-zero
    return fails the phase."""
    import torch

    from prosody_control_french_tts_tpu_torch.__main__ import main as cli_main

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main([str(a) for a in argv])
    torch.cuda.synchronize()
    if rc not in (None, 0):
        raise SystemExit(f"cli {argv[0]}: returned {rc}")
    return time.perf_counter() - t0


def a_b_launches() -> tuple[int, int]:
    from prosody_control_french_tts_tpu_torch.ops import candidates, viterbi

    return candidates.launches, viterbi.launches


def cli_config(base: Path, voice: str) -> Path:
    cfg = {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": [voice], "azure_voice_name": "fr-FR-DeniseNeural",
           "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300}, "tts_backend": "fake",
           "aligner": "precomputed", "steps_to_run": ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML",
                                                     "Synthesize+Merge", "Export JSON", "Final Transcribe", "Compare Breaks"],
           "ab_test": {"output_dir": "Out/AB_test", "num_pairs": 4, "target_duration_s": 30, "margin_s": 10}}
    path = base / "config.yaml"
    path.write_text(json.dumps(cfg), encoding="utf-8")  # JSON is YAML
    return path


def legacy_columns(path: Path) -> list:
    return [(r["syntagme"], float(r["relative_pitch_pct"]), float(r["loudness_adjustment"]), float(r["rate_adjustment"]))
            for r in read_csv(path)]


def legacy_phase(tmp: Path, seed: int, card: str) -> dict:
    """Phase 23.2: ``legacy`` on the measure voice laid out with its raw
    renderings, on the card; a 2-segment voice on the card and the CPU."""
    from prosody_control_french_tts_tpu_torch.legacy import bdd
    from prosody_control_french_tts_tpu_torch.utils.synth import lay_out_voice, synth_voice

    base = tmp / "cli"
    cfg = cli_config(base, LEGACY_VOICE)
    a0, b0 = a_b_launches()
    with Capture(bdd, "praat_pitch", keep=0, results=False) as tracks:
        seconds = cli(["legacy", "--config", cfg, "--voice", LEGACY_VOICE, "--device", "cuda"])
    a1, b1 = a_b_launches()
    out = base / "Out" / "results" / LEGACY_VOICE / "legacy"
    rows = read_csv(out / "BDD_ssml.csv")
    synts = read_csv(out / "BDD4.csv")
    if len(rows) != FULL_SEGMENTS or not all(r["ssml"].startswith("<speak") for r in rows) or not (out / "OUT.wav").exists():
        raise SystemExit(f"legacy: {len(rows)} BDD5 rows for {FULL_SEGMENTS} segments, or no OUT.wav")
    if (a1 - a0, b1 - b0) != (tracks.count, tracks.count) or tracks.count < 2 * FULL_SEGMENTS:
        raise SystemExit(f"legacy: A/B launches {a1 - a0}/{b1 - b0} for {tracks.count} pitch tracks")
    # the same 2-segment voice through the chain on the card and on the CPU
    gaps = []
    for dev in ("cuda", "cpu"):
        sb = tmp / f"cli_small_{dev}"
        synth_voice(sb / "synth", seed=seed + 1, n_segments=2, seconds=(3.0, 5.0))
        lay_out_voice(sb / "synth", sb / "Data" / "voice", "small")
        cli(["legacy", "--config", cli_config(sb, "small"), "--voice", "small", "--device", dev])
        gaps.append(legacy_columns(sb / "Out" / "results" / "small" / "legacy" / "BDD4.csv"))
    if [g[0] for g in gaps[0]] != [g[0] for g in gaps[1]]:
        raise SystemExit("legacy small voice: card and CPU syntagmes differ")
    gap = max((abs(x - y) for a, b in zip(*gaps) for x, y in zip(a[1:], b[1:])), default=0.0)
    if gap > TOL_LEGACY_CARD_CPU:
        raise SystemExit(f"legacy small voice: card vs CPU adjustments differ by {gap} points")
    print(f"cli legacy ({FULL_SEGMENTS} segments + raw renderings): {seconds:.3f} s, {len(rows)} BDD5 rows, "
          f"{len(synts)} syntagmes; pitch tracks {tracks.count} (of at most 4 floors x {2 * FULL_SEGMENTS} wavs), "
          f"A {a1 - a0} / B {b1 - b0} launches; 2-segment voice card vs CPU: largest adjustment gap {gap:.3e} points; card={card}")
    return dict(seconds=seconds, rows=len(rows), tracks=tracks.count, launches=(a1 - a0, b1 - b0), card_cpu_gap=gap)


def viewer_phase(tmp: Path, card: str) -> dict:
    """Phase 23.4 and 23.8: the viewer over the run's natural and raw
    segments, served on an ephemeral port, preloaded by four threads;
    plot data card vs CPU; ``device_trace`` around one plot."""
    import urllib.request

    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.core.profiling import device_trace
    from prosody_control_french_tts_tpu_torch.ops.stft import spectrogram
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav
    from prosody_control_french_tts_tpu_torch.viz.plotdata import compute_plot_data
    from prosody_control_french_tts_tpu_torch.viz.server import VizService, serve

    data = tmp / "cli" / "Data" / "voice"
    nat, raw = data / CLI_VOICE, data / f"{CLI_VOICE}_raw"
    ab_log = tmp / "cli" / "Out" / "ab_responses.jsonl"
    svc = VizService({"natural": nat / "audio", "synthetic": raw / "audio"},
                     {"natural": nat / "WhisperTS_textgrid_files"}, ab_log_path=ab_log, device="cuda")
    httpd = serve(svc, port=0, preload=False)
    port = httpd.server_address[1]
    url = f"http://127.0.0.1:{port}"
    try:
        a0, b0 = a_b_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.preload_all(workers=4)
        torch.cuda.synchronize()
        preload_s = time.perf_counter() - t0
        a1, b1 = a_b_launches()
        n = len(svc.cache)
        if n != 2 * FULL_SEGMENTS or (a1 - a0, b1 - b0) != (n, n):
            raise SystemExit(f"viewer: {n} plots preloaded, A/B launches {a1 - a0}/{b1 - b0}")
        segs = json.loads(urllib.request.urlopen(url + "/segments", timeout=60).read())
        if len(segs) != FULL_SEGMENTS:
            raise SystemExit(f"viewer: /segments lists {len(segs)}")
        get_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            pd = json.loads(urllib.request.urlopen(url + "/plot_data/natural/segment_ph1", timeout=60).read())
            get_ms.append((time.perf_counter() - t0) * 1e3)
        if not pd["intervals"] or not any(v is not None for v in pd["f0"]["hz"]):
            raise SystemExit("viewer: /plot_data without intervals or voiced frames")
        req = urllib.request.Request(url + "/ab_response", data=json.dumps({"segment": "segment_ph1", "choice": 1}).encode(),
                                     headers={"Content-Type": "application/json"})
        if json.loads(urllib.request.urlopen(req, timeout=60).read()) != {"status": "ok"}:
            raise SystemExit("viewer: /ab_response")
        if json.loads(ab_log.read_text(encoding="utf-8").splitlines()[-1])["segment"] != "segment_ph1":
            raise SystemExit("viewer: the A/B response was not logged")
    finally:
        httpd.shutdown()
        httpd.server_close()
    # one plot computed on the card (warm) against the CPU's
    wav, tg = nat / "audio" / "segment_ph2.wav", nat / "WhisperTS_textgrid_files" / "segment_ph2.TextGrid"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compute_plot_data(wav, tg, device="cuda")
    plot_ms = (time.perf_counter() - t0) * 1e3
    want = compute_plot_data(wav, tg, device="cpu")
    # the JSON's rounded spectrograms only as a check of structure; the values unrounded
    same_grid = np.shape(got["spectrogram"]["db"]) == np.shape(want["spectrogram"]["db"])
    x = torch.from_numpy(np.asarray(read_wav(wav).to_mono().samples, np.float32))
    pc, pp = (spectrogram(x.to(d), n_fft=1024, hop_length=256, db=False).double().cpu().numpy() for d in ("cuda", "cpu"))
    amp_gap = float(np.abs(np.sqrt(pc) - np.sqrt(pp)).max() / np.sqrt(pp.max()))
    db_c, db_p = (10 * np.log10(np.maximum(p, 1e-30) / p.max()) for p in (pc, pp))
    bright = db_p > -TOL_VIZ_DB_RANGE
    db_gap = float(np.abs(db_c - db_p)[bright].max())
    fg = np.array([np.nan if v is None else v for v in got["f0"]["hz"]])
    fw = np.array([np.nan if v is None else v for v in want["f0"]["hz"]])
    both = np.isfinite(fg) & np.isfinite(fw)
    f0_gap = float(np.abs(fg[both] / fw[both] - 1).max())
    voicing = float((np.isfinite(fg) == np.isfinite(fw)).mean())
    if (not same_grid or amp_gap > TOL_VIZ_AMP or db_gap > TOL_VIZ_DB or f0_gap > TOL_VIZ_F0 or voicing < 0.99
            or got["intervals"] != want["intervals"]):
        raise SystemExit(f"viewer plot card vs CPU: grid equal {same_grid}, amplitude {amp_gap} of the peak, dB {db_gap} "
                         f"within {TOL_VIZ_DB_RANGE} dB of the peak, F0 {f0_gap}, voicing agreement {voicing}")
    # device_trace around one plot: the trace names kernels A and B
    trace_dir = tmp / "cli" / "trace"
    with device_trace(trace_dir) as prof:
        compute_plot_data(wav, tg, device="cuda")
    traces = sorted(trace_dir.glob("trace_*.json"))
    text = traces[-1].read_text(encoding="utf-8") if traces else ""
    names = {k: text.count(k) for k in ("pitch_candidates_kernel", "viterbi_kernel")}
    if not all(names.values()):
        raise SystemExit(f"device_trace: {traces} names kernels {names}")
    dev_us = sum(e.device_time_total for e in prof.key_averages())
    print(f"cli viewer: {n} plots preloaded on 4 threads in {preload_s:.3f} s (A {a1 - a0} / B {b1 - b0} launches), "
          f"GET /plot_data (cached) {np.median(get_ms):.2f} ms median of 5, one plot computed on the card {plot_ms:.1f} ms; "
          f"card vs CPU (unrounded spectrogram): amplitude gap {amp_gap:.3e} of the peak, dB gap {db_gap:.3e} within "
          f"{TOL_VIZ_DB_RANGE:.0f} dB of the peak ({bright.mean():.4f} of bins); F0 gap {f0_gap:.3e}, voicing agreement {voicing:.4f}; "
          f"device_trace {traces[-1].name} ({traces[-1].stat().st_size} bytes) names {names}, device time {dev_us / 1e3:.3f} ms; card={card}")
    return dict(preload_s=preload_s, plots=n, launches=(a1 - a0, b1 - b0), get_ms=float(np.median(get_ms)),
                plot_ms=plot_ms, amp_gap=amp_gap, db_gap=db_gap, f0_gap=f0_gap)


def checkpoint_phase(tmp: Path, card: str) -> dict:
    """Phase 23.5: ``train_stage(ckpt_dir=...)`` on the card, 3 epochs,
    keep 2; the newest checkpoint restored into a fresh model generates
    the same text."""
    import torch

    from prosody_control_french_tts_tpu_torch.core.checkpoint import restore_train_state
    from prosody_control_french_tts_tpu_torch.models import cascade
    from prosody_control_french_tts_tpu_torch.models.llm import DecoderLM, LLMConfig
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer

    pairs = [{"x": s, "y": s.replace(",", " <break/>")} for s in (
        "le chat dort, le chien aussi", "il pleut, nous restons", "elle chante, il danse", "on part demain, si possible",
        "le train arrive, enfin", "tu viens, ou pas", "la voix change, beaucoup", "nous avons parlé, de musique")]
    tok = WordPieceTokenizer.train([cascade.format_example(cascade.TASK_A, p["x"], p["y"]) for p in pairs],
                                   vocab_size=200, min_freq=1)
    ckpt = tmp / "cli" / "ckpt"
    t0 = time.perf_counter()
    model, params, losses = cascade.train_stage(pairs, tok, epochs=3, batch_size=4, ckpt_dir=ckpt, ckpt_keep=2, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = sorted(p.name for p in ckpt.iterdir())
    if steps != ["step_00000002", "step_00000003"]:
        raise SystemExit(f"train_stage checkpoints: {steps}")
    restored, step = restore_train_state(ckpt, {"params": {k: torch.empty_like(v) for k, v in params.items()}})
    if step != 3 or not all(torch.equal(restored["params"][k], v) for k, v in params.items()):
        raise SystemExit("train_stage: the newest checkpoint is not the trained state")
    fresh = DecoderLM(LLMConfig(vocab_size=len(tok), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=256),
                      device="cuda", seed=99)
    fresh.load_state_dict(restored["params"])
    texts = [cascade.generate(m, tok, cascade.TASK_A, pairs[1]["x"], max_new=24, device="cuda") for m in (model, fresh)]
    if texts[0] != texts[1]:
        raise SystemExit(f"train_stage: the restored model generates {texts[1]!r}, the trained one {texts[0]!r}")
    print(f"cli train_stage on the card: 3 epochs ({len(losses)} steps, losses {losses[0]:.3f} -> {losses[-1]:.3f}) with "
          f"checkpoints in {train_s:.2f} s; kept {steps}; restored step {step} bit-equal, the same generated text; card={card}")
    return dict(train_s=train_s, losses=losses)


def hf_qwen2_state_dict(seed: int) -> dict:
    """Qwen2.5-7B's tensors under HF's names and layouts ([out, in] weights,
    q/k/v biases, an untied head), bfloat16, drawn on the card from the seed
    (HF's initializer_range 0.02; unit norms)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    c = QWEN25_7B_HF
    d, f, kv = c["hidden_size"], c["intermediate_size"], c["num_key_value_heads"] * (c["hidden_size"] // c["num_attention_heads"])

    def w(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(0.0, 0.02, generator=g)

    sd = {"model.embed_tokens.weight": w(c["vocab_size"], d), "model.norm.weight": torch.ones(d, dtype=torch.bfloat16, device="cuda"),
          "lm_head.weight": w(c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": torch.ones(d, dtype=torch.bfloat16, device="cuda"),
                   p + "post_attention_layernorm.weight": torch.ones(d, dtype=torch.bfloat16, device="cuda"),
                   p + "self_attn.q_proj.weight": w(d, d), p + "self_attn.q_proj.bias": w(d),
                   p + "self_attn.k_proj.weight": w(kv, d), p + "self_attn.k_proj.bias": w(kv),
                   p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.v_proj.bias": w(kv),
                   p + "self_attn.o_proj.weight": w(d, d),
                   p + "mlp.gate_proj.weight": w(f, d), p + "mlp.up_proj.weight": w(f, d), p + "mlp.down_proj.weight": w(d, f)})
    return sd


def hf_whisper_state_dict(seed: int) -> dict:
    """whisper-base's tensors under HF's ``WhisperForConditionalGeneration``
    names and layouts, float32, drawn on the card from the seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    c = WHISPER_BASE_HF
    d, f = c["d_model"], c["ffn"]

    def w(*shape):
        return torch.empty(shape, device="cuda").normal_(0.0, 0.02, generator=g)

    def ln(name):
        return {name + ".weight": torch.ones(d, device="cuda"), name + ".bias": torch.zeros(d, device="cuda")}

    def block(p, cross):
        out = {**ln(p + "self_attn_layer_norm"), **ln(p + "final_layer_norm"),
               p + "fc1.weight": w(f, d), p + "fc1.bias": w(f), p + "fc2.weight": w(d, f), p + "fc2.bias": w(d)}
        for a in ("self_attn",) + (("encoder_attn",) if cross else ()):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{p}{a}.{proj}.weight"] = w(d, d)
                if proj != "k_proj":
                    out[f"{p}{a}.{proj}.bias"] = w(d)
        if cross:
            out.update(ln(p + "encoder_attn_layer_norm"))
        return out

    sd = {"model.encoder.conv1.weight": w(d, c["num_mel_bins"], 3), "model.encoder.conv1.bias": w(d),
          "model.encoder.conv2.weight": w(d, d, 3), "model.encoder.conv2.bias": w(d),
          "model.encoder.embed_positions.weight": w(c["max_source_positions"], d),
          **ln("model.encoder.layer_norm"), **ln("model.decoder.layer_norm"),
          "model.decoder.embed_tokens.weight": w(c["vocab_size"], d),
          "model.decoder.embed_positions.weight": w(c["max_target_positions"], d)}
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    for i in range(c["encoder_layers"]):
        sd.update(block(f"model.encoder.layers.{i}.", cross=False))
    for i in range(c["decoder_layers"]):
        sd.update(block(f"model.decoder.layers.{i}.", cross=True))
    return sd


def converters_phase(seed: int, card: str) -> dict:
    """Phase 23.6: the HF converters at published widths, weights drawn on
    the card: Qwen2.5-7B → ``qwen2_to_torch`` → the fused serving tree →
    8 greedy tokens through kernel F; whisper-base → ``whisper_to_torch`` →
    ``WhisperAligner``, one 30 s window encoded and a few tokens decoded."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import nest
    from prosody_control_french_tts_tpu_torch.align.whisper import KVCache, WhisperAligner, WhisperConfig
    from prosody_control_french_tts_tpu_torch.convert import whisper_params_to_jax
    from prosody_control_french_tts_tpu_torch.models import llm
    from prosody_control_french_tts_tpu_torch.models.bpe_tokenizer import synthetic_multilingual
    from prosody_control_french_tts_tpu_torch.models.port_weights import llm_config_from_hf, qwen2_to_torch, whisper_to_torch
    from prosody_control_french_tts_tpu_torch.ops import decode_attn
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio

    out = {}
    torch.cuda.empty_cache()
    cfg = llm_config_from_hf(SimpleNamespace(**QWEN25_7B_HF))
    hf = hf_qwen2_state_dict(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = qwen2_to_torch(hf, cfg)  # float32, as the JAX converter
    for k in list(sd):  # each float32 tensor freed as its bfloat16 copy replaces it
        sd[k] = sd[k].to(torch.bfloat16)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    last = cfg.layers - 1
    if not (torch.equal(sd["layers.0.attn.k.kernel"], hf["model.layers.0.self_attn.k_proj.weight"].t())
            and torch.equal(sd[f"layers.{last}.mlp.down.kernel"], hf[f"model.layers.{last}.mlp.down_proj.weight"].t())
            and torch.equal(sd["layers.0.attn.q.bias"], hf["model.layers.0.self_attn.q_proj.bias"])
            and torch.equal(sd["lm_head.kernel"], hf["lm_head.weight"].t())):
        raise SystemExit("qwen2_to_torch: a converted tensor is not HF's in the port's layout")
    if len(sd) != 3 + cfg.layers * 12:  # embed, ln_f, head; a layer's 2 norms, q/k/v kernels and biases, o, gate, up, down
        raise SystemExit(f"qwen2_to_torch: {len(sd)} tensors")
    del hf
    fp = llm.fuse_decode_params(sd, cfg)
    del sd
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(seed)).to(torch.int32)
    serve(fp, cfg, prompt, CLI_NEW_TOKENS)  # cold
    decode_attn.launches = 0
    toks, gen_s = serve(fp, cfg, prompt, CLI_NEW_TOKENS)
    f_launches = decode_attn.launches
    if f_launches != cfg.layers * (CLI_NEW_TOKENS - 1):
        raise SystemExit(f"converted 7B: kernel F launched {f_launches} times, expected {cfg.layers * (CLI_NEW_TOKENS - 1)}")
    check_served_tokens(fp, cfg, prompt, toks, CLI_NEW_TOKENS)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"cli converter Qwen2.5-7B geometry (28 layers, dim 3584, 28/4 heads, ffn 18944, vocab 152064, bf16, weights drawn "
          f"on the card): qwen2_to_torch + cast to bf16 {convert_s:.3f} s, peak {peak_gib:.2f} GiB (the bf16 HF tree and the float32 converted one); "
          f"fused serving tree, {CLI_NEW_TOKENS} greedy tokens for 4 prompts of 16 in {gen_s * 1e3:.1f} ms (warm), "
          f"kernel F {f_launches} launches, peak {serve_peak:.2f} GiB; card={card}")
    out.update(qwen_convert_s=convert_s, qwen_peak_gib=peak_gib, qwen_tokens_ms=gen_s * 1e3, f_launches=f_launches)
    del fp
    torch.cuda.empty_cache()

    wcfg = WhisperConfig.base()
    hf = hf_whisper_state_dict(seed)
    t0 = time.perf_counter()
    wsd = whisper_to_torch(hf, wcfg)
    torch.cuda.synchronize()
    wconvert_s = time.perf_counter() - t0
    del hf
    # the aligner keeps its weights as the flax-layout tree it saves (WhisperAligner.params)
    al = WhisperAligner(wcfg, params=nest(whisper_params_to_jax(wsd, wcfg.heads)), tokenizer=synthetic_multilingual(),
                        use_vad=False, detect_disfluencies=False, device="cuda")
    if not all(torch.equal(v, wsd[k].to(v.dtype)) for k, v in al.model.state_dict().items()):
        raise SystemExit("whisper_to_torch: the aligner's weights are not the converted tensors")
    x = (0.1 * np.random.default_rng(seed).normal(size=30 * 16000)).astype(np.float32)
    mel = al.features(Audio(x, 16000))[None]  # [1, 3000, 80]: one 30 s window
    with torch.no_grad():
        al.model.encode(mel)  # cold
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = al.model.encode(mel)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        kvs = al.model.cross_kv(enc)
        hd = wcfg.dim // wcfg.heads

        def greedy4() -> list:
            caches = [KVCache(1, 8, wcfg.heads, hd, wcfg.dtype, "cuda") for _ in range(wcfg.dec_layers)]
            toks = [50258]
            for pos in range(4):
                logits, _ = al.model.decode_step(torch.tensor([[toks[-1]]], device="cuda"), pos, caches, kvs)
                toks.append(int(logits[0, -1].argmax()))
            return toks

        cold = greedy4()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy4()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 4
        if toks != cold:
            raise SystemExit(f"whisper-base: the warm greedy steps {toks} differ from the cold ones {cold}")
        forced, _ = al.model.decode(torch.tensor([toks[:-1]], device="cuda"), enc)
    if enc.shape != (1, wcfg.n_audio_ctx, wcfg.dim) or not torch.isfinite(enc).all() or not torch.isfinite(forced).all():
        raise SystemExit(f"whisper-base: encoder output {tuple(enc.shape)} or logits not finite")
    if forced[0].argmax(-1).tolist() != toks[1:]:
        raise SystemExit(f"whisper-base: greedy steps {toks[1:]} != the teacher-forced argmax {forced[0].argmax(-1).tolist()}")
    tg = al.align(Audio(x[: 3 * 16000], 16000), "bonjour le monde")
    if not tg.tiers or not tg.tiers[0]:
        raise SystemExit("whisper-base: the aligner gave no TextGrid tier")
    print(f"cli converter whisper-base geometry (d 512, 6 + 6 layers, 8 heads, 80 mels, vocab 51865, weights drawn on the "
          f"card): whisper_to_torch {wconvert_s:.3f} s; WhisperAligner encodes a 30 s window in {enc_ms:.2f} ms (warm), "
          f"{step_ms:.2f} ms a greedy token (4 tokens after 4 of warm-up, equal to the teacher-forced argmax); align() on 3 s gave a TextGrid; card={card}")
    out.update(whisper_convert_s=wconvert_s, whisper_encode_ms=enc_ms, whisper_step_ms=step_ms)
    del al, wsd
    torch.cuda.empty_cache()
    return out


def sinc_pitch_phase(tmp: Path, card: str) -> dict:
    """Phase 23.7: ``praat_pitch`` with ``sinc_refine_steps=2`` on one
    segment on the card and the CPU."""
    import numpy as np

    from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams, praat_pitch
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    a = read_wav(tmp / "cli" / "Data" / "voice" / CLI_VOICE / "audio" / "segment_ph1.wav").to_mono()
    x = np.asarray(a.samples, np.float32)
    p = PitchParams(sinc_refine_steps=2)
    a0, b0 = a_b_launches()
    t0 = time.perf_counter()
    fc = praat_pitch(x, a.rate, p, device="cuda").f0.cpu().numpy()
    card_s = time.perf_counter() - t0
    a1, b1 = a_b_launches()
    fp = praat_pitch(x, a.rate, p, device="cpu").f0.numpy()
    parabolic = praat_pitch(x, a.rate, device="cuda").f0.cpu().numpy()
    both = (fc > 0) & (fp > 0)
    gap = float(np.abs(fc[both] / fp[both] - 1).max())
    agree = float((((fc == 0) & (fp == 0)) | np.isclose(fc, fp, rtol=1e-3, atol=0)).mean())
    moved = float(np.median(np.abs(fc[both & (parabolic > 0)] / parabolic[both & (parabolic > 0)] - 1)))
    if (a1 - a0, b1 - b0) != (1, 1) or agree < 0.995 or both.sum() < 100:
        raise SystemExit(f"sinc pitch: launches {a1 - a0}/{b1 - b0}, frames agreeing {agree}, voiced in both {both.sum()}")
    print(f"cli praat_pitch sinc_refine_steps=2 ({a.duration_seconds:.1f} s segment, {fc.size} frames): card {card_s * 1e3:.1f} ms "
          f"(A, B once); card vs CPU: {agree:.4f} of frames agree (voicing, F0 1e-3), largest F0 gap {gap:.3e} relative where "
          f"both voiced; median move from the parabolic track {moved:.2e}; card={card}")
    return dict(gap=gap, agree=agree, launches=(a1 - a0, b1 - b0))


def cli_phase(tmp: Path, seed: int, card: str) -> dict:
    """Phase 23 of the module docstring → its measurements and the launches
    of A and B (``run``, ``legacy``, the viewer, the sinc track) and F (the
    converted 7B tree)."""
    import torch

    from prosody_control_french_tts_tpu_torch.utils.synth import lay_out_voice, synth_voice

    t_phase = time.perf_counter()
    base = tmp / "cli"
    synth_voice(base / "synth", seed=seed, n_segments=FULL_SEGMENTS)
    for name in (CLI_VOICE, LEGACY_VOICE):
        lay_out_voice(base / "synth", base / "Data" / "voice", name)
    audio_s = sum(read_wav_seconds(p) for p in (base / "synth" / "audio").glob("*.wav"))
    cfg = cli_config(base, CLI_VOICE)
    out = {}
    # 1. run: the seven steps after Preprocess (the voice is already split)
    cli(["run", "--config", cfg, "--device", "cuda"])  # cold
    a0, b0 = a_b_launches()
    run_s = cli(["run", "--config", cfg, "--device", "cuda"])
    a1, b1 = a_b_launches()
    if (a1 - a0, b1 - b0) != (1, 1):
        raise SystemExit(f"cli run: A/B launched {a1 - a0}/{b1 - b0} times, expected once each")
    res = base / "Out" / "results" / CLI_VOICE
    steps = {json.loads(line)["step"]: json.loads(line)["seconds"] for line in (res / "step_timings.jsonl").read_text().splitlines()}
    if len(read_csv(res / "BDD_ssml.csv")) != FULL_SEGMENTS or not (res / "OUT.wav").exists():
        raise SystemExit("cli run: BDD_ssml.csv or OUT.wav")
    print(f"cli run ({FULL_SEGMENTS} segments, {audio_s:.1f} s, precomputed TextGrids, fake TTS): warm {run_s:.3f} s, "
          f"{audio_s / run_s:.1f} audio-s/s; A {a1 - a0} / B {b1 - b0} launches; steps (s) {json.dumps(steps)}; card={card}")
    out["run"] = dict(seconds=run_s, audio_s=audio_s, steps=steps, launches=(a1 - a0, b1 - b0))
    # 2. legacy
    out["legacy"] = legacy_phase(tmp, seed, card)
    # 3. sync, corpus + analyze, abtest (host)
    host = {}
    host["sync"] = cli(["sync", "--config", cfg, "--voice", CLI_VOICE])
    host["corpus"] = cli(["corpus", base / "Data" / "voice", base / "corpus"])
    host["analyze"] = cli(["analyze", base / "corpus"])
    host["abtest"] = cli(["abtest", "--config", cfg])
    sync_wavs = len(list((res / "synchronized").rglob("*.wav")))
    pairs = len(list((base / "Out" / "AB_test").glob("*/raw.wav")))
    if not sync_wavs or not pairs:
        raise SystemExit(f"cli sync / abtest: {sync_wavs} synchronized wavs, {pairs} A/B pairs")
    print(f"cli host commands (s): {json.dumps({k: round(v, 3) for k, v in host.items()})}; {sync_wavs} synchronized wavs, "
          f"{pairs} A/B pairs; card={card}")
    # 4, 8. the viewer and device_trace
    out["viewer"] = viewer_phase(tmp, card)
    # 5. train_stage with checkpoints
    out["checkpoints"] = checkpoint_phase(tmp, card)
    # 7. the sinc-refined pitch track
    out["sinc"] = sinc_pitch_phase(tmp, card)
    # 6. the converters at published widths (last: the 7B tree is the largest allocation)
    out["converters"] = converters_phase(seed, card)
    torch.cuda.empty_cache()
    out["launches_a"] = {"run": out["run"]["launches"][0], "legacy": out["legacy"]["launches"][0],
                         "viewer": out["viewer"]["launches"][0], "sinc_track": out["sinc"]["launches"][0]}
    out["launches_b"] = {"run": out["run"]["launches"][1], "legacy": out["legacy"]["launches"][1],
                         "viewer": out["viewer"]["launches"][1], "sinc_track": out["sinc"]["launches"][1]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 23 took {out['phase_s']:.1f} s; card={card}")
    return out


def read_wav_seconds(path: Path) -> float:
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    return read_wav(path).duration_seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from prosody_control_french_tts_tpu_torch.core import profiling
    from prosody_control_french_tts_tpu_torch.core.pipeline import CSV_NAMES, measure_and_build_ssml
    from prosody_control_french_tts_tpu_torch.ops import candidates, kernels, pitch, viterbi
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import bucket_length
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    card = card_line()
    print(card)
    dev = torch.device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = start_ptxas_report()
    lib = kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({kernels.build().name})")
    print_ptxas_report(ptxas, lib)

    settings = ProsodySettings()
    voice_name = "fr-FR-DeniseNeural"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- 2. full-width voice through the main path ---------------------
        t0 = time.perf_counter()
        seg_files, tg_dir, raw_dir = synth_voice(tmp / "voice", seed=args.seed, n_segments=FULL_SEGMENTS)
        audio_s = 0.0
        longest = 0
        for p in seg_files:
            n = (p.stat().st_size - 44) // 2
            audio_s += n / 44100
            longest = max(longest, n)
        print(f"voice: {len(seg_files)} segments, {audio_s:.1f} s of audio, padded T = {bucket_length(longest)}, "
              f"synthesised in {time.perf_counter() - t0:.1f} s")

        candidates.launches = 0
        viterbi.launches = 0
        profiling.reset_phases()
        t0 = time.perf_counter()
        result = measure_and_build_ssml(seg_files, tg_dir, raw_dir, tmp / "out", settings, voice_name, 1.0, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {"pitch_candidates": candidates.launches, "viterbi": viterbi.launches}
        cold_phases = dict(profiling.PHASES)
        print(f"main path launches: {json.dumps(launches)}")
        for name, n in launches.items():
            if n < 1:
                raise SystemExit(f"kernel {name} was not launched on the main path")

        # -- 3. checks on the result --------------------------------------
        rows = result.rows
        if not rows:
            raise SystemExit("no syntagme rows")
        vals = np.array([[r.raw_pitch, r.raw_volume, r.raw_rate, r.pitch_smooth, r.rate_smooth] for r in rows])
        if not np.isfinite(vals).all():
            raise SystemExit("non-finite measure rows")
        stats = np.array([[s.p_nat, s.l_nat, s.l_syn] for s in result.seg_stats])
        if not np.isfinite(stats).all() or not (stats[:, 0] > 0).all():
            raise SystemExit(f"bad segment stats {stats}")
        for name in CSV_NAMES:
            got = read_csv(tmp / "out" / name)
            want = len({r.segment for r in rows}) if name == "BDD_ssml.csv" else len(rows)
            if len(got) != want or not all(r["ssml"].startswith("<speak") for r in got):
                raise SystemExit(f"{name}: {len(got)} rows, expected {want}")
        print(f"result: {len(rows)} syntagme rows, segment F0 medians {np.round(stats[:, 0], 1).tolist()} Hz, "
              f"LUFS {np.round(stats[:, 1], 2).tolist()}")

        # warm run, capturing each kernel's full-width inputs
        profiling.reset_phases()
        with Capture(candidates, "topk_parabolic") as cap_a, Capture(viterbi, "viterbi_path") as cap_b:
            t0 = time.perf_counter()
            measure_and_build_ssml(seg_files, tg_dir, raw_dir, tmp / "out2", settings, voice_name, 1.0, device="cuda")
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        warm_phases = dict(profiling.PHASES)
        trace = profile_measure(lambda: measure_and_build_ssml(
            seg_files, tg_dir, raw_dir, tmp / "out3", settings, voice_name, 1.0, device="cuda"))

        tone = (0.5 * np.sin(2 * np.pi * 200.0 * np.arange(44100) / 44100)).astype(np.float32)
        f0 = pitch.praat_pitch(tone, 44100, device="cuda").f0.cpu().numpy()
        tone_med = float(np.median(f0[f0 > 0]))
        if abs(tone_med - 200.0) > 1.0:
            raise SystemExit(f"200 Hz tone measured at {tone_med} Hz")

        small = synth_voice(tmp / "small", seed=args.seed + 1, n_segments=3, seconds=(1.0, 2.0))
        res_gpu = measure_and_build_ssml(*small, tmp / "sg", settings, voice_name, 1.0, device="cuda")
        res_cpu = measure_and_build_ssml(*small, tmp / "sc", settings, voice_name, 1.0, device="cpu")
        small_err = max(
            max(abs(a.pitch_smooth - b.pitch_smooth), abs(a.rate_smooth - b.rate_smooth), abs(a.raw_volume - b.raw_volume))
            for a, b in zip(res_gpu.rows, res_cpu.rows)
        )
        if len(res_gpu.rows) != len(res_cpu.rows) or small_err > 0.05:
            raise SystemExit(f"small voice: card vs CPU differ by {small_err} points")
        print(f"reference: 200 Hz tone -> {tone_med:.3f} Hz; small voice card vs CPU max |diff| {small_err:.2e} points")

        # -- 4. the eight-step voice pipeline --------------------------------
        pipe_counts = pipeline_phase(tmp, args.seed, card)

        # -- 15. the multi-voice pipeline and its denoisers --------------------
        mv = multi_voice_phase(tmp, card, cap_b.calls[0][0])

        # -- 21. the contextual POS tagger and the evaluation layer -------------
        pos_eval_phase(tmp, args.seed, card, mv["base"])

        # -- 5. kernels C/D and E against their plain versions, and their times
        cde_rows = kernels_cde_phase(seg_files, card)
        for row in cde_rows:
            row["launches"] = pipe_counts["chunk_cumsum" if row["name"] == "chunk_cumsum" else "frames"]

    # -- 6. kernels A and B vs plain on the measure path's own tensors ------
    (r, k, min_lag, max_lag, vth), _ = cap_a.calls[0]
    (delta, lf, voiced, freq, vuv, jump), _ = cap_b.calls[0]
    err_a, err_b = check_a_b(cap_a.calls, cap_b.calls, "the measure voice")
    # the kernels line's max |err|: over the measure voice and the multi-voice groups
    err_a, err_b = max(err_a, mv["err_a"]), max(err_b, mv["err_b"])

    # -- 7. timing of A and B ----------------------------------------------
    R, L = r.shape
    # A's outputs depend on the lags min_lag - 1 .. max_lag of each row only,
    # and it reads no others; the bound over whole rows is printed beside
    bytes_a = R * (max_lag - min_lag + 2) * 4 + R * k * (4 + 4 + 1)
    bytes_a_rows = R * L * 4 + R * k * (4 + 4 + 1)
    lag = torch.arange(L, device=dev)
    r_m1 = torch.cat([r[:, :1], r[:, :-1]], -1)
    r_p1 = torch.cat([r[:, 1:], r[:, -1:]], -1)
    score = torch.where((r > r_m1) & (r >= r_p1) & (r > 0.5 * vth) & (lag >= min_lag) & (lag < max_lag), r, float("-inf"))
    # two copies of r in turn (2 x 56 MB, past the 50 MB L2): L2 cold, as C/D/E
    r_copies, turn = [r, r.clone()], [0]

    def call_a():
        turn[0] += 1
        return candidates.topk_parabolic(r_copies[turn[0] % 2], k, min_lag, max_lag, vth)

    ms_a = graph_ms(call_a, reps=20)
    ms_a_one_copy = graph_ms(lambda: candidates.topk_parabolic(r, k, min_lag, max_lag, vth), reps=20)
    events_a = cuda_ms(lambda: candidates.topk_parabolic(r, k, min_lag, max_lag, vth), reps=50)
    plain_a = graph_ms(lambda: candidates.topk_parabolic_plain(r, k, min_lag, max_lag, vth), reps=3)
    lib_a = graph_ms(lambda: torch.topk(score, k, dim=-1), reps=10)
    del r_copies

    S, F, K = delta.shape
    bytes_b = S * F * K * (4 + 4 + 1 + 4) + S * F * 4
    ms_b = cuda_ms(lambda: viterbi.viterbi_path(delta, lf, voiced, freq, vuv, jump), reps=20)
    plain_b = cuda_ms(lambda: viterbi.viterbi_path_plain(delta, lf, voiced, freq, vuv, jump), reps=1, warmup=0)

    floor = viterbi_chain_floor(lib, F, K)

    rows_out = []
    for spec, n, ms, plain_ms, lib_ms, nbytes, err in (
        (KERNEL_A, launches["pitch_candidates"], ms_a, plain_a, lib_a, bytes_a, err_a),
        (KERNEL_B, launches["viterbi"], ms_b, plain_b, None, bytes_b, err_b),
    ):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        extra_b = dict(floor, ms_s30=mv["viterbi_s30_ms"], ms_s10=mv["viterbi_s10_ms"]) if spec is KERNEL_B else {}
        rows_out.append(dict(spec, launches=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by="bytes", library_ms=lib_ms, check="pass",
                             multi_voice_launches=mv["launches"][spec["name"]], **extra_b))
        extra = (f"; chain_floor_ms={floor['chain_floor_ms']:.4f} ({floor['chain_floor']}); "
                 f"the one-warp design: {B_PREVIOUS_MS} ms (PERF.md, not measured here)") if spec is KERNEL_B else (
            f" (CUDA-graph replay over two copies of r, L2 cold; on one copy {ms_a_one_copy:.4f}, between CUDA events "
            f"around eager calls {events_a:.4f}; plain and torch.topk by graph replay; the bound over whole rows "
            f"{bytes_a_rows / HBM_BYTES_PER_S * 1e3:.5f} ({bytes_a_rows} bytes)); the argmax-rounds design: "
            f"{A_PREVIOUS_MS} ms (PERF.md, CUDA events, not measured here)")
        print(f"kernel {spec['name']}: ms={ms:.4f} launches={n} bound_ms={bound:.5f} (bytes {nbytes}) "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"max_abs_err={err:.3e} card={card}{extra}")

    rows_out.extend(cde_rows)
    rows_out.append(mv["mask_ema"])
    rows_out.append(llm_phases(args, card))
    rows_out.extend(train_phases(args, card))

    # -- 16-19. the acoustic aligners and the pipeline with them -------------
    whisper_align_phase(card)
    whisper_small_decode_phase(card, args.seed)
    ctc = ctc_align_phase(card)
    with tempfile.TemporaryDirectory() as tmp2:
        ap = aligner_pipeline_phase(Path(tmp2), args.seed, card)
    rows_out.append(ctc_kernel_row(ctc["calls"] + ap["ctc"]["calls"], ap["ctc"]["counts"]["ctc_viterbi"], card, lib))

    # -- 20. the break-predictor serving path ---------------------------------
    break_tagger_phase(card, args.seed, mv["bdd_json"])

    # -- 22. the training halves of the aligners and the separator -------------
    rows_out.append(aligner_training_phase(card, lib, args.seed)["ctc_loss_row"])

    # -- 23. the umbrella command line and the host front ends -----------------
    with tempfile.TemporaryDirectory() as tmp3:
        cli_out = cli_phase(Path(tmp3), args.seed, card)
    for row in rows_out:
        if row["name"] in ("pitch_candidates", "viterbi"):
            row["cli_launches"] = cli_out["launches_a" if row["name"] == "pitch_candidates" else "launches_b"]
        elif row["name"] == "decode_attn":
            row["cli_launches"] = {"converted_7b": cli_out["converters"]["f_launches"]}

    print(f"measure step (warm): wall {warm_s:.3f} s, {audio_s / warm_s:.1f} audio-s/s; cold {cold_s:.3f} s; card={card}")
    print("phases warm: " + json.dumps({k2: round(v, 4) for k2, v in sorted(warm_phases.items())}))
    print("phases cold: " + json.dumps({k2: round(v, 4) for k2, v in sorted(cold_phases.items())}))
    print("profile (warm measure step): " + json.dumps(trace))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

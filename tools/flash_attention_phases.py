#!/usr/bin/env python3
"""The flash attention's bfloat16 forward split by phase, two designs tried
and not kept, and what ptxas makes of its warp-specialised kernels.

    python3 tools/flash_attention_phases.py [--reps 12]

Run from the root of a checkout, on a machine with an H100. It compiles
``csrc/flash_attention.cu`` as it is and copies of it with one phase of the
forward cut (each by the line it replaces; the tool stops if that line is not
found once, or at all for the one that edits every occurrence):

- ``no_softmax``: the online softmax is skipped (p is the raw score);
- ``no_exp``: the softmax keeps its max, sums and rescale but not its exp2;
- ``no_pv``: O += P V is not issued;
- ``no_s``: S = Q K^T is not issued (the softmax reads stale registers);
- ``no_kv_stream``: only the first K/V tiles a block needs are loaded, the
  later stages are released without a copy (the products read stale tiles),
  so the forward runs without streaming K/V from L2;
- ``trap_waits``: the consumers wait with the trapping ``mbar_wait`` instead
  of ``mbar_wait_bounded`` (kept for its ptxas report only: a ``__trap`` after
  ``setmaxnreg.inc`` makes ptxas allocate the consumers at the kernel's entry
  count and spill);

and two designs that were tried and not kept, rebuilt on the sound source:

- ``pingpong``: the forward's two consumer warpgroups take turns to issue
  their products (named barriers 1 and 2), so that one's softmax runs while
  the other's products use the tensor cores;
- ``cluster_sum``: the dk/dv blocks of a KV group (up to 8) run as one
  thread-block cluster and add their float32 partials through distributed
  shared memory in rank order, instead of writing them to device memory for
  ``flash_dkv_group_sum``.

It prints each build's ptxas registers and spills for the bf16 kernels, then
times each build's forward and backward (CUDA-graph replays, L2 cold, as
``chip_smoke.py`` times them) on random bfloat16 inputs at the 7B layer shape
(B 2, H 28, KV heads 4, L 1024, hd 128) and the bench shape (8, 14, 2, 768,
64) through ``flash_attention_gqa``, beside ``scaled_dot_product_attention``
(is_causal) on K/V repeated to all heads. The cut builds compute wrong
values; only the sound build's are checked (``chip_smoke.FA_LIMITS``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CUTS = {
    "no_softmax": [("    softmax(kt, alpha);\n", ""), ("  softmax(0, alpha);\n", "  alpha[0] = alpha[1] = 1.0f;\n")],
    "no_exp": [("      s[i] = fast_exp2(fmaf(s[i], c2, -m[(i >> 1) & 1]));", "      s[i] = fmaf(s[i], c2, -m[(i >> 1) & 1]);")],
    "no_pv": [("    issue_s(st.s);\n    issue_pv(prev);", "    issue_s(st.s);\n    wgmma_commit();")],
    "no_s": [("    issue_s(st.s);\n    issue_pv(prev);", "    wgmma_commit();\n    issue_pv(prev);")],
    "no_kv_stream": [(
        "        mbar_expect_tx(bar.full(st.s), 2 * TILE);\n"
        "        const uint32_t sk = s_kv + st.s * 2 * TILE;\n"
        "        load_tile_tma<HD>(sk, &tm_k, kvh, kt * BM, b, BM, bar.full(st.s));\n"
        "        load_tile_tma<HD>(sk + TILE, &tm_v, kvh, kt * BM, b, BM, bar.full(st.s));\n",
        "        const uint32_t sk = s_kv + st.s * 2 * TILE;\n"
        "        if (kt < STAGES) {\n"
        "          mbar_expect_tx(bar.full(st.s), 2 * TILE);\n"
        "          load_tile_tma<HD>(sk, &tm_k, kvh, kt * BM, b, BM, bar.full(st.s));\n"
        "          load_tile_tma<HD>(sk + TILE, &tm_v, kvh, kt * BM, b, BM, bar.full(st.s));\n"
        "        } else {\n"
        "          mbar_arrive(bar.full(st.s));\n"
        "        }\n",
    )],
    "trap_waits": [("mbar_wait_bounded(", "mbar_wait(")],
    # designs tried and not kept, rebuilt on the sound source
    "pingpong": [
        ("  // Tile kt's S is issued before tile kt - 1's P V, and its softmax runs while\n  // that product is in flight (wgmma groups complete in order).\n  mbar_wait_bounded(bar.once, 0);\n  Stage st;\n  mbar_wait_bounded(bar.full(st.s), st.phase);\n  wgmma_fence();\n  issue_s(st.s);\n  wgmma_wait<0>();",
         "  // Tile kt's S is issued before tile kt - 1's P V, and its softmax runs while\n  // that product is in flight (wgmma groups complete in order). The two\n  // warpgroups take turns to issue their products (named barriers 1 and 2,\n  // 256 threads: a warpgroup's sync waits for the other's arrive), so that\n  // one's softmax runs while the other's products use the tensor cores.\n  const int mine = 1 + at_.half, other = 2 - at_.half;\n  if (at_.half == 1) named_arrive(1);  // the first turn is warpgroup 0's\n  mbar_wait_bounded(bar.once, 0);\n  Stage st;\n  mbar_wait_bounded(bar.full(st.s), st.phase);\n  named_sync(mine);\n  wgmma_fence();\n  issue_s(st.s);\n  named_arrive(other);\n  wgmma_wait<0>();"),
        ('    mbar_wait_bounded(bar.full(st.s), st.phase);\n    wgmma_fence();\n    issue_s(st.s);\n    issue_pv(prev);\n    wgmma_wait<1>();',
         '    mbar_wait_bounded(bar.full(st.s), st.phase);\n    named_sync(mine);\n    wgmma_fence();\n    issue_s(st.s);\n    issue_pv(prev);\n    named_arrive(other);\n    wgmma_wait<1>();'),
        ('  wgmma_fence();\n  issue_pv(st.s);\n  wgmma_wait<0>();\n  pin(acc);\n  if (signals) mbar_arrive(bar.empty(st.s));\n',
         "  named_sync(mine);\n  wgmma_fence();\n  issue_pv(st.s);\n  named_arrive(other);\n  wgmma_wait<0>();\n  pin(acc);\n  if (signals) mbar_arrive(bar.empty(st.s));\n  if (at_.half == 0) named_sync(mine);  // warpgroup 1's last arrive\n"),
        ('template <int R>\n__device__ __forceinline__ void zero(float (&d)[R]) {',
         '// named barriers id (1 or 2) of the two consumer warpgroups: a warpgroup\'s\n// sync completes once the other warpgroup has arrived\n__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory"); }\n__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory"); }\n\ntemplate <int R>\n__device__ __forceinline__ void zero(float (&d)[R]) {'),
    ],
    "cluster_sum": [
        ('#include <cuda.h>\n#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n#include <math.h>\n#include <stdint.h>\n\n#include "hopper.cuh"\n\nnamespace {\n\nusing namespace hopper;\n',
         '#include <cooperative_groups.h>\n#include <cuda.h>\n#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n#include <math.h>\n#include <stdint.h>\n\n#include "hopper.cuh"\n\nnamespace {\n\nnamespace cg = cooperative_groups;\nusing namespace hopper;\n'),
        ("constexpr int STAT_BYTES = 1024; // a dk/dv stage's lse2 and di (2 x 64 floats), padded to a swizzle atom",
         "constexpr int STAT_BYTES = 1024; // a dk/dv stage's lse2 and di (2 x 64 floats), padded to a swizzle atom\n// the largest group whose dk/dv blocks add their partials as one thread-block\n// cluster (the portable cluster size); larger groups go through float32\n// partials in device memory and flash_dkv_group_sum\nconstexpr int kMaxClusterGroup = 8;"),
        ('// dk/dv, one block per plan item (b, h, 128 keys)',
         "// dk or dv of a key tile summed over the group: the cluster's blocks (rank g\n// the group's head g) put their float32 partials in their own shared memory\n// (`red`, rows HD + 4 floats apart), then each block adds the ranks' partials\n// in rank order for the rows r with r % group == its rank, reading the others'\n// shared memory, and writes them in bf16. Two cluster barriers; the producer\n// warpgroup takes part in both.\ntemplate <int HD>\n__device__ __forceinline__ void cluster_add(const float (&acc)[HD / 2], float* red, bf16* out, Str so, int b, int k0,\n                                            int kvh, const Place& at_, int group) {\n  constexpr int LD = HD + 4;\n  cg::cluster_group cluster = cg::this_cluster();\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n#pragma unroll\n    for (int j = 0; j < HD / 8; ++j) {\n      *reinterpret_cast<float2*>(red + (at_.row + 8 * r) * LD + 8 * j + at_.colq) =\n          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);\n    }\n  }\n  cluster.sync();\n  const int rank = (int)cluster.block_rank();\n  for (int i = threadIdx.x - 128; i < BM * (HD / 4); i += 256) {\n    const int row = i / (HD / 4), c = (i % (HD / 4)) * 4;\n    if (row % group != rank) continue;\n    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n    for (int g = 0; g < group; ++g) {\n      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red + row * LD + c, g));\n      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;\n    }\n    *reinterpret_cast<uint2*>(out + at(so, b, k0 + row, kvh) + c) =\n        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));\n  }\n  cluster.sync();  // no block leaves, or reuses `red`, while another reads it\n}\n\n// dk/dv, one block per plan item (b, h, 128 keys)"),
        ('               float* __restrict__ dk_part, float* __restrict__ dv_part, bf16* __restrict__ dk, Str sdk,\n               bf16* __restrict__ dv, Str sdv, int H, int group, int L, float scale) {',
         '               float* __restrict__ dk_part, float* __restrict__ dv_part, bf16* __restrict__ dk, Str sdk,\n               bf16* __restrict__ dv, Str sdv, int H, int group, int L, float scale, int cluster_sum) {'),
        ('        st.advance();\n      }\n    }\n    return;\n  }\n  setmaxnreg_inc<240>();\n  const Place at_;\n  const bool signals = threadIdx.x % 128 == 0;\n  const float c2 = scale * kLog2e;\n  const int kw',
         "        st.advance();\n      }\n    }\n    if (cluster_sum) {  // the two cluster barriers of each of the consumers' two cluster_add\n      cg::cluster_group cluster = cg::this_cluster();\n      for (int i = 0; i < 4; ++i) cluster.sync();\n    }\n    return;\n  }\n  setmaxnreg_inc<240>();\n  const Place at_;\n  const bool signals = threadIdx.x % 128 == 0;\n  const float c2 = scale * kLog2e;\n  const int kw"),
        ('  const unsigned char* gen = smem_tc + (s_k - smem_u32(smem_tc));  // generic address of s_k',
         '  unsigned char* gen = smem_tc + (s_k - smem_u32(smem_tc));  // generic address of s_k'),
        ('    if (signals) mbar_arrive(bar.empty(st.s));\n    st.advance();\n  }\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n    const int key = k0 + at_.row + 8 * r;\n    if (group == 1) {',
         '    if (signals) mbar_arrive(bar.empty(st.s));\n    st.advance();\n  }\n  if (cluster_sum) {\n    asm volatile("bar.sync 3, 256;" ::: "memory");  // both consumers are done with the stage ring, which now takes the partials\n    float* red = reinterpret_cast<float*>(gen + (s_st - s_k));\n    cluster_add<HD>(acc_k, red, dk, sdk, b, k0, h / group, at_, group);\n    cluster_add<HD>(acc_v, red, dv, sdv, b, k0, h / group, at_, group);\n    return;\n  }\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n    const int key = k0 + at_.row + 8 * r;\n    if (group == 1) {'),
        ('    if ((rc = set_smem(flash_dkv_bf16<HD>, bkv))) return rc;\n    flash_dkv_bf16<HD><<<blocks, kThreadsTC, bkv, stream>>>(tk2, tv2, tq2, tdo2, plan_k, lse2, di, dk_part, dv_part,\n                                                            (bf16*)dk, st[6], (bf16*)dv, st[7], H, group, L, scale);\n    if ((rc = (int)cudaGetLastError())) return rc;\n    if (group > 1) {',
         "    if ((rc = set_smem(flash_dkv_bf16<HD>, bkv))) return rc;\n    const int cluster_sum = group > 1 && group <= kMaxClusterGroup;\n    cudaLaunchConfig_t cfg = {};\n    cfg.gridDim = dim3(blocks);\n    cfg.blockDim = dim3(kThreadsTC);\n    cfg.dynamicSmemBytes = bkv;\n    cfg.stream = stream;\n    cudaLaunchAttribute attr[1];\n    attr[0].id = cudaLaunchAttributeClusterDimension;  // the group's blocks (consecutive in the plan) as one cluster\n    attr[0].val.clusterDim.x = cluster_sum ? group : 1;\n    attr[0].val.clusterDim.y = 1;\n    attr[0].val.clusterDim.z = 1;\n    cfg.attrs = attr;\n    cfg.numAttrs = 1;\n    if ((rc = (int)cudaLaunchKernelEx(&cfg, flash_dkv_bf16<HD>, tk2, tv2, tq2, tdo2, plan_k, (const float*)lse2,\n                                      (const float*)di, dk_part, dv_part, (bf16*)dk, st[6], (bf16*)dv, st[7], H, group,\n                                      L, scale, cluster_sum))) {\n      return rc;\n    }\n    if ((rc = (int)cudaGetLastError())) return rc;\n    if (group > kMaxClusterGroup) {"),
    ],
}
EVERYWHERE = {"trap_waits"}  # cuts that edit every occurrence of their anchors
SHAPES = {"7B": (2, 28, 4, 1024, 128), "bench": (8, 14, 2, 768, 64)}


def build_all(tmp: Path) -> dict:
    """The sound source and every cut copy, compiled in parallel with -Xptxas -v:
    name -> (.so path, ptxas text)."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    src = (kernels.CSRC / "flash_attention.cu").read_text()
    texts = {"sound": src}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if (text.count(old) < 1) if name in EVERYWHERE else (text.count(old) != 1):
                raise SystemExit(f"cut {name}: the anchor is not found {'at all' if name in EVERYWHERE else 'once'} in "
                                 f"flash_attention.cu: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-Xptxas", "-v", "-shared", str(cu),
               "-o", str(tmp / f"{name}.so")]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (cmd, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} ({' '.join(cmd)}):\n{text}")
        out[name] = (tmp / f"{name}.so", text)
    return out


def load(path: Path):
    from prosody_control_french_tts_tpu_torch.ops import kernels

    lib = ctypes.CDLL(str(path))
    for fn, args in kernels._SIGNATURES.items():
        if fn.startswith("flash_attn_"):
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = cs.card_line()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        builds = build_all(Path(tmp))
        for name, (_, text) in builds.items():
            rows = cs.ptxas_rows(text, r"(flash_(?:fwd|dq|dkv)_bf16)ILi(\d+)E")
            print(f"ptxas {name}: " + ", ".join(f"{k} {v.get('registers')} registers, {v.get('spill_stores')} bytes spilled"
                                                for k, v in sorted(rows.items())))
        libs = {name: load(path) for name, (path, _) in builds.items() if name != "trap_waits"}
        rng = np.random.default_rng(0)
        ok = True
        for label, (B, H, KVH, L, hd) in SHAPES.items():
            scale = float(hd**-0.5)
            group = H // KVH
            mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()  # noqa: E731
            sets = [(mk(B, L, H, hd), mk(B, L, KVH, hd), mk(B, L, KVH, hd), mk(B, L, H, hd)) for _ in range(6)]
            lib_sets = [(a.transpose(1, 2).contiguous(), flash_attention.repeat_kv(b, group).contiguous(),
                         flash_attention.repeat_kv(c, group).contiguous(), d.transpose(1, 2).contiguous()) for a, b, c, d in sets]

            def with_fn(f):
                def make_call(inputs, grad):
                    qq, kk, vv, dd = inputs
                    if grad:
                        qq, kk, vv = (t.detach().requires_grad_(True) for t in (qq, kk, vv))
                    return f(qq, kk, vv), dd, (qq, kk, vv)

                return make_call

            sdpa = cs.fwd_bwd_ms(with_fn(lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True)), lib_sets, args.reps)
            print(f"{label} {(B, H, KVH, L, hd)} SDPA (K/V repeated): fwd {sdpa['fwd']:.4f} ms, bwd {sdpa['bwd']:.4f} ms")
            q, k, v, dout = sets[0]
            want = cs.attn_grads(cs.flash_plain, q, k, v, dout, scale)
            ref = [t.float() for t in cs.attn_grads(cs.flash_plain, q.float(), k.float(), v.float(), dout.float(), scale)]
            for name, lib in libs.items():
                kernels._LIB = lib
                if name == "sound":
                    got = cs.attn_grads(cs.flash_call, q, k, v, dout, scale)
                    errs = [cs.fa_measure(a, b, r, i > 0) for i, (a, b, r) in enumerate(zip(got, want, ref))]
                    lim = cs.FA_LIMITS["bf16"]
                    ok &= errs[0] <= lim.fwd and max(errs[1:]) <= lim.grad
                    print(f"{label} sound: FA measure forward {errs[0]:.3e}, dq/dk/dv {' / '.join(f'{e:.3e}' for e in errs[1:])}")
                t = cs.fwd_bwd_ms(with_fn(lambda a, b, c: cs.flash_call(a, b, c, scale)), sets, args.reps)
                print(f"{label} {name}: fwd {t['fwd']:.4f} ms ({t['fwd'] / sdpa['fwd']:.2f}x SDPA), "
                      f"bwd {t['bwd']:.4f} ms ({t['bwd'] / sdpa['bwd']:.2f}x SDPA) card={card}", flush=True)
            del sets, lib_sets
        kernels._LIB = None
    print("sound build within FA_LIMITS" if ok else "sound build OUTSIDE FA_LIMITS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

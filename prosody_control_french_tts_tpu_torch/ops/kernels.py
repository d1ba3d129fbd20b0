"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface (pointers and the stream as
``void*``, each function returns ``cudaGetLastError()``), so they build
with ``nvcc`` alone in seconds, without PyTorch's headers, and bind with
``ctypes``. The build runs at first use, from the sources in the checkout,
into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``); a content hash of the sources and of the headers they
share (``csrc/*.cuh``) names the library, so an edited source or header is
rebuilt. Each source compiles to its own object in
parallel, and one link makes the shared library.

Nothing here is touched by a CPU tensor: the wrappers in ``ops.candidates``,
``ops.viterbi``, ``ops.decode_attn``, ``ops.vmem_attn``, ``ops.fused_ce``,
``ops.frames``, ``ops.chunk_cumsum``, ``ops.flash_attention``, ``ops.mask_ema``, ``ops.ctc_viterbi`` and ``ops.ctc_loss`` take their
plain PyTorch versions only for tensors on the CPU, and call :func:`library` only for CUDA tensors — a failed build
or launch raises, there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
SOURCES = (
    "pitch_candidates.cu", "viterbi.cu", "decode_attn.cu", "vmem_attn.cu", "fused_ce.cu",
    "frames.cu", "chunk_cumsum.cu", "flash_attention.cu", "mask_ema.cu", "ctc_viterbi.cu", "ctc_loss.cu",
)
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

# --fmad=false: torch rounds every multiply and add on its own; a fused
# multiply-add in the kernels would round differently from the plain
# versions the kernels are held against. (decode_attn.cu, vmem_attn.cu and
# fused_ce.cu, held to a tolerance, ask for their fused multiply-adds
# explicitly with fmaf.)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
)

_LIB = None
# one build and one load a process: the first callers of ``library`` may be
# several threads at once (the viewer's preload pool), and each would start
# its own nvcc processes on the same objects
_LIB_LOCK = threading.Lock()
# the wrappers' launch counters are read-modify-writes on module globals:
# wrappers that threads may call at once count under this lock
COUNT_LOCK = threading.Lock()

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # r, lag_f, strength, valid, rows, L, k, min_lag, max_lag, half_vth, stream
    "pitch_candidates_launch": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP),
    # min_lag, max_lag -> bytes of dynamic shared memory
    "pitch_candidates_smem_bytes": (_I, _I),
    # delta, lf, voiced, freq, back, f0, S, F, K, vuv_cost, jump_cost, stream
    "viterbi_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _VP),
    # K bound of the instantiation (16 or 32) -> bytes of dynamic shared memory
    "viterbi_smem_bytes": (_I,),
    # out, op (0 shuffles, 1 float add + max), steps, stream
    "viterbi_latency_probe": (_VP, _I, _I, _VP),
    # q, kc, vc, out, B, S, kv_heads, group, hd, pos, scale, dtype, blocks per cluster, stream
    "decode_attn_launch": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _F, _I, _I, _VP),
    # dtype, hd, S, blocks per cluster -> bytes of dynamic shared memory
    "decode_attn_smem_bytes": (_I, _I, _I, _I),
    # q, k, v, o, lse, B, L, H, KVH, hd, scale, dtype, stream
    "vmem_attn_fwd_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _I, _VP),
    # q, k, v, do, lse, delta, dq, dk, dv, B, L, H, KVH, hd, scale, stream (float32)
    "vmem_attn_bwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP),
    # q, k, v, o, do, lse, delta, plan, n_plan, dk_part, dv_part, dq, dk, dv, B, L, H, KVH, hd, scale, stream
    "vmem_attn_bwd_bf16_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                  _I, _I, _I, _I, _I, _F, _VP),
    # kernel (0 forward, 1 dq, 2 dk/dv), hd -> bytes of dynamic shared memory
    "vmem_attn_bf16_smem_bytes": (_I, _I),
    # h, w, tgt, nll, lse, partials, N, D, V, splits, tiles_per_split, dtype, stream
    "fused_ce_fwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    # h, w, tgt, lse, g, coef, dh, N, D, V, chunk, dh_cols, dtype, stream
    "fused_ce_bwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    # dtype (0 float32, 1 bfloat16), output columns of a tile -> bytes of dynamic shared memory
    "fused_ce_smem_bytes": (_I, _I),
    # x, starts, window, out, B, T, F, W, stream
    "frames_launch": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP),
    # x, out, R, C, stream
    "chunk_cumsum_launch": (_VP, _VP, _I, _I, _VP),
    # mask, out, scratch, enter, fixups, F, T, smooth, 1 - smooth, warm-up frames, stream
    "mask_ema_launch": (_VP, _VP, _VP, _VP, _VP, _I, ctypes.c_longlong, _F, _F, _I, _VP),
    # T -> chunks of a bin's row (the entered states' row length)
    "mask_ema_chunks": (ctypes.c_longlong,),
    # log_probs, ext, skip, input_len, label_len, back, states, score, B, T, S, V, states a thread, blocks a
    # sequence (0, 0: the defaults), stream
    "ctc_viterbi_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    # S -> states a thread by default (0: more than the kernel takes)
    "ctc_viterbi_states_per_thread": (_I,),
    # S, states a thread -> blocks of a sequence's cluster by default
    "ctc_viterbi_cluster_blocks": (_I, _I),
    # V -> frames of a ring tile (0: V too wide)
    "ctc_viterbi_tile_frames": (_I,),
    # T, S, states a thread, blocks -> 32-bit words of a sequence's packed pointers (returns a 64-bit int)
    "ctc_viterbi_back_words": (_I, _I, _I, _I),
    # log_probs, ext, skip, alpha, loss, T, S, V, frames advanced, label_len, stream
    "ctc_loss_fwd_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    # alpha, skip, col_ptr, col_states, grad_out, de (scratch [Tv, S]), dlogp, T, S, V, frames advanced, label_len,
    # stream
    "ctc_loss_bwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    # () -> states the kernels take at most
    "ctc_loss_max_states": (),
    # S, V -> bytes of dynamic shared memory of the backward (returns a 64-bit int)
    "ctc_loss_bwd_smem_bytes": (_I, _I),
    # S -> states a thread (0: more than the kernels take)
    "ctc_loss_states_per_thread": (_I,),
    # out, steps, stream: one state's forward step as a dependent chain in one thread
    "ctc_loss_latency_probe": (_VP, _I, _VP),
    # q, k, v, o, l, m, plan, n_plan, B, H, KVH, L, hd, strides (12 int64, host), scale, dtype, stream
    "flash_attn_fwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _F, _I, _VP),
    # q, k, v, o, do, l, m, di, lse2, dk_part, dv_part, dq, dk, dv, plan_q, plan_k, n_plan, B, H, KVH, L, hd,
    # strides (24 int64, host), scale, dtype, stream
    "flash_attn_bwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                              _I, _I, _I, _I, _I, _VP, _F, _I, _VP),
    # kernel (0 forward, 1 dq, 2 dk/dv), hd, dtype (0 float32, 1 bfloat16) -> bytes of dynamic shared memory
    "flash_attn_smem_bytes": (_I, _I, _I),
}


_RESTYPES = {"ctc_viterbi_back_words": ctypes.c_longlong, "ctc_loss_bwd_smem_bytes": ctypes.c_longlong}  # every other function returns an int


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default of every entry
    point; asking for it on a host without a card raises (a CPU run must be
    asked for with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dsp_precision() -> None:
    """Full float32 for the DSP path: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path."""
    h = hashlib.sha256()
    for path in [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libpcft_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out.decode(errors='replace')}")
    tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           *map(str, objs), "-o", str(tmp)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout.decode(errors='replace')}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded kernel library (built on first use; concurrent first
    callers wait for one build and one load)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for fn, args in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = list(args)
                f.restype = _RESTYPES.get(fn, ctypes.c_int)
            _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device: torch.device) -> None:
    """Wrapper argument check: what the kernel does not take raises."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

"""Weight-only quantization for the LLM stack.

The reference's stage-B model loads Qwen2.5-7B in 4-bit NF4 through
bitsandbytes. Here weights are STORED quantized (int8 per output channel,
int8 blockwise, or NF4-codebook 4-bit blockwise packed two per byte) and
dequantized to the compute dtype where they are used. LoRA adapters, biases
and norms stay float32 (the QLoRA recipe: quantized base, full-precision
adapters).

Kernels are laid out ``[in, out]``; blocks and NF4 nibble pairs run along
axis 0, the contraction axis. Each quantizer takes a numpy array, and then
runs in numpy on the host, or a torch tensor, and then runs in torch on the
tensor's device (the card, for a 7B tree: the numpy NF4 quantizer builds an
[in, out, 16] float32 distance tensor and takes about 10 s a 7B MLP kernel).
The two paths make the same codes and scales byte for byte: the same float32
division by the block scale, the first index of the least ``|x - t|`` over
the NF4 table, ``rint`` half to even for int8; the torch path divides by a
tensor (CUDA turns a division by a host scalar into a multiplication by its
reciprocal) and works in column chunks of at most :data:`QUANT_CHUNK_BYTES`
of intermediates. Neither path hands off to the other. The dequantizers and
:func:`matmul_int8_block` take torch tensors on the CPU or the card; on the
card :func:`dequant_nf4` is one launch of a CUDA kernel (``ops.nf4_dequant``).

Parameter trees here are flat ``state_dict`` mappings of
``models.llm.DecoderLM`` (``layers.0.attn.q.kernel`` …):
:func:`quantize_params` turns every projection's ``kernel`` into
``kernel_q`` + ``kernel_scale``, the tree that
``DecoderLM(LLMConfig(quant=...))`` loads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.profiling import span
from ..ops import nf4_dequant

# The QLoRA NF4 codebook: 16 quantiles of N(0,1) normalised to [-1, 1]
# (public constants from the QLoRA paper / bitsandbytes).
NF4_TABLE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    np.float32,
)

NF4_BLOCK = 64  # bitsandbytes' default blocksize

# every kernel dequantized (dequant_int8, dequant_nf4): calls, and the least
# bytes each moves (the codes and float32 scales read once, the result
# written once at its dtype's width). Always counted, as the ops' launches.
dequant_calls = 0
dequant_bytes = 0

# LoRALinear projection names inside DecoderLM — the quantized set
# (embed/lm_head stay in compute dtype, like the reference's skip_modules)
_PROJ_NAMES = {"q", "k", "v", "o", "gate", "up", "down"}

# the torch quantizers' intermediates for one column chunk, at most (the NF4
# quantizer's [in, cols, 16] float32 distances)
QUANT_CHUNK_BYTES = 256 << 20


def _column_chunks(in_f: int, out_f: int, bytes_per_col: int):
    """Column slices of an [in, out] kernel whose intermediates, at
    ``bytes_per_col`` a column, stay within :data:`QUANT_CHUNK_BYTES`."""
    cols = max(1, QUANT_CHUNK_BYTES // bytes_per_col)
    for c0 in range(0, out_f, cols):
        yield slice(c0, min(out_f, c0 + cols))


_ON_DEVICE: dict[tuple[str, torch.device], torch.Tensor] = {}


def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """The module's table ``name`` (``NF4_TABLE``, ``NF4_PAIRS``,
    ``NF4_INT8_TABLE``) on ``device``, copied there once: a copy from host
    memory in every call would hold the host until the device is idle."""
    key = (name, torch.device(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(globals()[name]).to(device)
    return _ON_DEVICE[key]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, for exact divisions there."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _quantize_int8_torch(w: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 per (block of ``block`` rows, column) on ``w``'s
    device: (int8 [in, out], f32 scale [in/block, out]). ``rint`` is
    ``torch.round``, half to even."""
    in_f, out_f = w.shape
    q = torch.empty((in_f, out_f), dtype=torch.int8, device=w.device)
    scale = torch.empty((in_f // block, out_f), dtype=torch.float32, device=w.device)
    d127 = _f32(127.0, w)
    for cols in _column_chunks(in_f, out_f, in_f * 16):
        wb = w[:, cols].float().reshape(in_f // block, block, -1)
        s = torch.clamp_min(wb.abs().amax(dim=1), 1e-12) / d127  # [in/block, cols]
        q[:, cols] = torch.clamp(torch.round(wb / s[:, None, :]), -127, 127).to(torch.int8).reshape(in_f, -1)
        scale[:, cols] = s
    return q, scale


# ---------------------------------------------------------------------------
# int8: per-output-channel absmax
# ---------------------------------------------------------------------------


def quantize_kernel_int8(w):
    """f32 [in, out] → (int8 [in, out], f32 scale [out]) with symmetric
    per-output-channel absmax scaling. A torch tensor is quantized on its
    device (any float dtype, read as float32)."""
    if isinstance(w, torch.Tensor):
        q, scale = _quantize_int8_torch(w, w.shape[0])  # one block: the whole column
        return q, scale[0]
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _count_dequant(codes: torch.Tensor, scale: torch.Tensor, weights: int, dtype: torch.dtype) -> None:
    global dequant_calls, dequant_bytes
    dequant_calls += 1
    dequant_bytes += codes.numel() * codes.element_size() + scale.numel() * scale.element_size() + weights * dtype.itemsize


def dequant_int8(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    _count_dequant(q, scale, q.numel(), dtype)
    with span("quant.dequant"):
        return (q.float() * scale[None, :].float()).to(dtype)


# ---------------------------------------------------------------------------
# int8b: blockwise int8 — the NF4 *serving* layout
# ---------------------------------------------------------------------------


def quantize_kernel_int8_block(w, block: int = NF4_BLOCK):
    """f32 [in, out] → (int8 [in, out], f32 scale [in/block, out]) with
    symmetric absmax per (contraction-block, output-column) — the direct
    quantizer for the int8b serving layout (recode_nf4_to_int8_block
    produces the same layout FROM an NF4 checkpoint). A torch tensor is
    quantized on its device."""
    in_f, out_f = w.shape
    if in_f % block:
        raise ValueError(f"in_features {in_f} not divisible by block {block}")
    if isinstance(w, torch.Tensor):
        return _quantize_int8_torch(w, block)
    w = np.asarray(w, np.float32)
    wb = w.reshape(in_f // block, block, out_f)
    scale = np.maximum(np.abs(wb).max(axis=1), 1e-12) / 127.0  # [nb, out]
    q = np.clip(np.rint(wb / scale[:, None, :]), -127, 127).astype(np.int8)
    return q.reshape(in_f, out_f), scale.astype(np.float32)


def dequant_int8_block(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype, block: int = NF4_BLOCK) -> torch.Tensor:
    """int8 [in, out] × f32 scale [in/block, out] → dtype [in, out]."""
    in_f, out_f = q.shape
    w = q.float().reshape(in_f // block, block, out_f) * scale[:, None, :]
    return w.reshape(in_f, out_f).to(dtype)


def matmul_int8_block(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    dtype: torch.dtype,
    block: int = NF4_BLOCK,
    row_cutoff: int = 256,
) -> torch.Tensor:
    """``x @ dequant_int8_block(q, scale)`` without rounding the kernel.

    Few rows (decode): a batched ``block``-deep product over the scale
    blocks, the f32 scales applied to the f32 per-block partial sums — the
    int8 codes convert to ``dtype`` exactly, so no dequantized weight is
    rounded. Many rows (prefill, training), or a contraction length that
    ``block`` does not divide: the dense dequantized product.

    The partial sums must be float32: ``torch.bmm`` on bfloat16 returns
    bfloat16, so both operands are upcast first (exact), which makes the
    products and their sums float32."""
    in_f, out_f = q.shape
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= int(d)
    if rows > row_cutoff or in_f % block:
        return x @ dequant_int8_block(q, scale, dtype, block)
    nb = in_f // block
    xb = x.reshape(rows, nb, block).transpose(0, 1).to(dtype).float()  # [nb, R, blk]
    qb = q.reshape(nb, block, out_f).to(dtype).float()  # [nb, blk, out]
    part = torch.bmm(xb, qb)  # [nb, R, out] f32
    y = (part * scale[:, None, :].float()).sum(0)
    return y.to(dtype).reshape(*lead, out_f)


# ---------------------------------------------------------------------------
# NF4
# ---------------------------------------------------------------------------


def quantize_kernel_nf4(w, block: int = NF4_BLOCK):
    """f32 [in, out] → (uint8 packed [in/2, out], f32 scale [in/block, out]).

    Blocks run along the input dim (contraction axis). Codes are argmin
    distance to the NF4 table of w/absmax(block); rows 2i (low nibble) and
    2i+1 (high nibble) pack into byte i. A torch tensor is quantized on its
    device, a column chunk at a time."""
    in_f, out_f = w.shape
    if in_f % block or in_f % 2:
        raise ValueError(f"in_f {in_f} must be divisible by block {block} (and 2)")
    if isinstance(w, torch.Tensor):
        return _quantize_nf4_torch(w, block)
    w = np.asarray(w, np.float32)
    blocks = w.reshape(in_f // block, block, out_f)
    scale = np.maximum(np.abs(blocks).max(axis=1), 1e-12)  # [in/block, out]
    normed = blocks / scale[:, None, :]
    codes = np.abs(normed.reshape(in_f, out_f)[..., None] - NF4_TABLE).argmin(-1).astype(np.uint8)
    packed = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32)


def _quantize_nf4_torch(w: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    in_f, out_f = w.shape
    dev = w.device
    table = _on_device("NF4_TABLE", dev)
    packed = torch.empty((in_f // 2, out_f), dtype=torch.uint8, device=dev)
    scale = torch.empty((in_f // block, out_f), dtype=torch.float32, device=dev)
    for cols in _column_chunks(in_f, out_f, in_f * NF4_TABLE.size * 4):
        blocks = w[:, cols].float().reshape(in_f // block, block, -1)
        s = torch.clamp_min(blocks.abs().amax(dim=1), 1e-12)  # [in/block, cols]
        normed = (blocks / s[:, None, :]).reshape(in_f, -1)
        # argmin takes the first of equal distances, as numpy's does
        codes = (normed[..., None] - table).abs_().argmin(dim=-1).to(torch.uint8).reshape(in_f // 2, 2, -1)
        packed[:, cols] = codes[:, 0] | (codes[:, 1] << 4)
        scale[:, cols] = s
    return packed, scale


def _nf4_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 packed [in/2, out] → codes 0..15 [in, out] (int64, for indexing)."""
    half, out_f = packed.shape
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.stack([lo, hi], dim=1).reshape(half * 2, out_f).long()


# the two NF4 levels of each packed byte: [2, 256], row 0 the low nibble's
# (ops.nf4_dequant.nf4_dequant_plain's lookup)
NF4_PAIRS = np.stack([NF4_TABLE[np.arange(256) & 0xF], NF4_TABLE[np.arange(256) >> 4]])


def dequant_nf4(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype, block: int = NF4_BLOCK) -> torch.Tensor:
    """Codebook lookup → blockwise rescale in float32 → ``dtype``
    (``ops.nf4_dequant``: one CUDA kernel launch for a CUDA tensor, the
    plain PyTorch version for a CPU tensor; the same bits)."""
    half, out_f = packed.shape
    _count_dequant(packed, scale, half * 2 * out_f, dtype)
    with span("quant.dequant"):
        return nf4_dequant.nf4_dequant(packed, scale, dtype, block)


# NF4 levels on the int8 grid (|round(t*127) - t*127| ≤ 0.5 → value error
# ≤ 0.5/127 ≈ 0.4 % of block absmax, far inside NF4's own ~3 % step size)
NF4_INT8_TABLE = np.rint(NF4_TABLE * 127.0).astype(np.int8)


def recode_nf4_to_int8_block(packed, scale, block: int = NF4_BLOCK):
    """One-time load recode of an NF4 kernel into the int8b serving layout:
    the 16 NF4 levels mapped onto the int8 grid (per kernel; torch tensors on
    their device, numpy arrays on the host), so serving streams int8 codes
    instead of looking up a codebook per weight per token. NF4 on disk /
    int8b on the wire."""
    if isinstance(packed, torch.Tensor):
        half, out_f = packed.shape
        table = _on_device("NF4_INT8_TABLE", packed.device)
        q = torch.empty((half * 2, out_f), dtype=torch.int8, device=packed.device)
        for cols in _column_chunks(half * 2, out_f, 16):
            q[:, cols] = table[_nf4_codes(packed[:, cols])]
        return q, scale.float() / _f32(127.0, scale)
    packed = np.asarray(packed)
    scale = np.asarray(scale, np.float32)
    half, out_f = packed.shape
    lo = packed & np.uint8(0xF)
    hi = packed >> np.uint8(4)
    codes = np.stack([lo, hi], axis=1).reshape(half * 2, out_f)
    return NF4_INT8_TABLE[codes], scale / 127.0


# ---------------------------------------------------------------------------
# tree conversion (flat state_dict mappings of DecoderLM)
# ---------------------------------------------------------------------------


def _is_proj_kernel(key: str, leaf: str) -> bool:
    parts = key.split(".")
    return len(parts) >= 2 and parts[-1] == leaf and parts[-2] in _PROJ_NAMES


def quantize_params(params: dict, mode: str, block: int = NF4_BLOCK) -> dict:
    """Float DecoderLM tree → quantized tree: every projection's ``kernel``
    becomes ``kernel_q`` + ``kernel_scale``, quantized on the kernel's
    device; everything else (biases, adapters, norms, embed, lm_head) passes
    through unchanged."""
    if mode not in ("int8", "nf4"):
        raise ValueError(f"unknown quant mode {mode!r}")
    out = {}
    for key, val in params.items():
        if not _is_proj_kernel(key, "kernel"):
            out[key] = val
            continue
        w = val.detach()
        out[key + "_q"], out[key + "_scale"] = quantize_kernel_int8(w) if mode == "int8" else quantize_kernel_nf4(w, block)
    return out


def recode_params_nf4_serving(params: dict, block: int = NF4_BLOCK) -> dict:
    """Convert every NF4 kernel (uint8 packed ``kernel_q``) of a quantized
    tree to the int8b serving layout, on the kernel's device; int8 and float
    leaves pass through. Use with ``LLMConfig(quant="int8b")``."""
    out = dict(params)
    for key, val in params.items():
        if _is_proj_kernel(key, "kernel_q") and val.dtype == torch.uint8:
            skey = key[: -len("_q")] + "_scale"
            out[key], out[skey] = recode_nf4_to_int8_block(val, params[skey], block)
    return out


def dequantize_params(params: dict, block: int = NF4_BLOCK) -> dict:
    """Inverse of :func:`quantize_params`: expand every ``kernel_q`` /
    ``kernel_scale`` pair back to a float32 ``kernel`` (mode inferred from
    the storage: int8 with 1-D scales → per-channel, int8 with 2-D scales →
    int8b, uint8 → NF4 packed). Running the FLOAT model on this tree
    reproduces the quantized model's outputs."""
    out = {}
    for key, val in params.items():
        if key.endswith(".kernel_scale") and key[: -len("_scale")] + "_q" in params:
            continue
        if not _is_proj_kernel(key, "kernel_q"):
            out[key] = val
            continue
        s = params[key[: -len("_q")] + "_scale"]
        if val.dtype == torch.int8:
            w = dequant_int8_block(val, s, torch.float32, block) if s.dim() == 2 else dequant_int8(val, s, torch.float32)
        else:
            w = dequant_nf4(val, s, torch.float32, block)
        out[key[: -len("_q")]] = w
    return out


def quantized_bytes(params) -> int:
    """Total bytes of a parameter tree (a state_dict, or the nested fused
    serving tree)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    raise TypeError(f"quantized_bytes: unexpected leaf {type(params).__name__}")

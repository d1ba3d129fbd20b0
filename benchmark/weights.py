"""The weights of a cell, made from its seed on the device in a few large
calls, in the type the base is served in (bfloat16). The program and the
plain reference each call :func:`make` with the same seed and get the same
values; neither takes the other's.

Values follow the source's ``initializer_range``: kernels, the embedding,
the head and the q/k/v biases N(0, range²); the norms' scales N(1, 0.1²), so
that they are not all ones; LoRA ``A`` N(0, 1/r²) and ``B`` zero, fresh
adapters as a fine-tuning run starts them.
"""

from __future__ import annotations

import torch

KINDS = ("q", "k", "v", "o", "gate", "up", "down")
BIASED = ("q", "k", "v")


def shapes(dims: dict) -> dict:
    """(in, out) of each projection of a layer."""
    d, hd = dims["dim"], dims["dim"] // dims["heads"]
    return {"q": (d, dims["heads"] * hd), "k": (d, dims["kv_heads"] * hd), "v": (d, dims["kv_heads"] * hd),
            "o": (dims["heads"] * hd, d), "gate": (d, dims["ffn"]), "up": (d, dims["ffn"]), "down": (dims["ffn"], d)}


def make(dims: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """name → tensor: ``embed`` [V, D], ``head`` [D, V], ``ln_f`` [D]; per
    layer, stacked on a leading layer axis: each projection's kernel
    ``<kind>`` [layers, in, out], the biases ``b<kind>`` of q, k and v,
    ``ln1`` and ``ln2`` [layers, D], and float32 ``A.<kind>`` [layers, in, r]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    std, n, d, v = dims["init_std"], dims["layers"], dims["dim"], dims["vocab_size"]

    def normal(shape, mean=0.0, s=std, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device).normal_(mean, s, generator=gen)

    out = {"embed": normal((v, d)), "head": normal((d, v)), "ln_f": normal((d,), 1.0, 0.1)}
    for kind, (i, o) in shapes(dims).items():
        out[kind] = normal((n, i, o))
        if kind in BIASED:
            out["b" + kind] = normal((n, o))
    out["ln1"], out["ln2"] = normal((n, d), 1.0, 0.1), normal((n, d), 1.0, 0.1)
    r = dims["lora_rank"]
    for kind, (i, o) in shapes(dims).items():
        out["A." + kind] = normal((n, i, r), 0.0, 1.0 / r, torch.float32)
    return out

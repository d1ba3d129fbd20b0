"""The yardstick: operations and bytes that a training micro-step of a
decoder LM needs, computed from the configuration's shapes, and the card's
peaks they are held against.

Every product the computation needs is counted once, whatever implements it:

- recompute under remat is not counted (the forward is needed once);
- a product that a kernel computes again to save memory is not counted (the
  fused cross-entropy's backward recomputes the logits: not counted);
- elementwise work, norms, rope, softmax and the embedding gather count no
  operations.

So a change that swaps one kernel for another, or drops a recompute, cannot
push a share of a peak over 100 % by the yardstick's own fault.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def projection_shapes(cfg: dict) -> dict:
    """(in, out) of each of a decoder layer's seven projections."""
    d, hd = cfg["dim"], cfg["dim"] // cfg["heads"]
    return {
        "q": (d, cfg["heads"] * hd),
        "k": (d, cfg["kv_heads"] * hd),
        "v": (d, cfg["kv_heads"] * hd),
        "o": (cfg["heads"] * hd, d),
        "gate": (d, cfg["ffn"]),
        "up": (d, cfg["ffn"]),
        "down": (cfg["ffn"], d),
    }


def layer_weights(cfg: dict) -> int:
    """Weights of one decoder layer's products (biases and norms are
    elementwise work and are left out)."""
    return sum(i * o for i, o in projection_shapes(cfg).values())


def head_weights(cfg: dict) -> int:
    """Weights of the untied LM head."""
    return cfg["dim"] * cfg["vocab_size"]


def dense_weights(cfg: dict) -> int:
    """N: the weights that every token goes through, layers and head."""
    return cfg["layers"] * layer_weights(cfg) + head_weights(cfg)


def lora_flops_per_token(cfg: dict) -> int:
    """6·r·(in + out) a token for each adapted projection: forward x·A and
    (x·A)·B (2·r·(in + out)), their input gradients (the same again) and the
    gradients of A and B (the same again); summed over the layers."""
    r = cfg["lora_rank"]
    return cfg["layers"] * sum(6 * r * (i + o) for i, o in projection_shapes(cfg).values())


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Causal attention of one micro-step, every layer: forward QKᵀ and PV,
    backward dV, dP, dQ and dK; each product 2·B·H·L²·hd, halved for
    causality (the masked half of the scores is not needed)."""
    hd = cfg["dim"] // cfg["heads"]
    per_product = 2 * batch * cfg["heads"] * seq * seq * hd // 2
    return cfg["layers"] * 6 * per_product


def head_rows(batch: int, seq: int) -> int:
    """Rows the LM head and its loss see: every position but a row's last."""
    return batch * (seq - 1)


def flops_per_token(cfg: dict, seq: int) -> float:
    """The model operations a trained token needs at length ``seq``: the
    dense products forward (2N) and their input gradients (2N; the base and
    the head are frozen, so no weight gradient), the adapters, and the
    token's share of the causal attention."""
    return 4 * dense_weights(cfg) + lora_flops_per_token(cfg) + attention_flops(cfg, 1, seq) / seq


def microstep_flops(cfg: dict, batch: int, seq: int) -> int:
    """The model operations of one micro-step of ``batch`` rows of ``seq``
    tokens: the layers' products and adapters at every position, the head at
    the positions that have a next token, the attention."""
    tokens = batch * seq
    layers = 4 * cfg["layers"] * layer_weights(cfg) + lora_flops_per_token(cfg)
    return tokens * layers + 4 * head_weights(cfg) * head_rows(batch, seq) + attention_flops(cfg, batch, seq)


def attention_bytes(cfg: dict, batch: int, seq: int, elem: int = 2) -> int:
    """Bytes of the attention work of one micro-step, every layer: inputs q,
    k, v and the output gradient read once, outputs o, dq, dk and dv written
    once (k, v and their gradients at the KV heads)."""
    hd = cfg["dim"] // cfg["heads"]
    q = batch * seq * cfg["heads"] * hd * elem
    kv = batch * seq * cfg["kv_heads"] * hd * elem
    return cfg["layers"] * (q + 2 * kv + q) + cfg["layers"] * (q + q + 2 * kv)


def head_ce_flops(cfg: dict, batch: int, seq: int) -> int:
    """The LM head's cross-entropy of one micro-step: the logits h·W
    (2·rows·D·V) and the hidden state's gradient from them (2·rows·D·V)."""
    return 4 * head_rows(batch, seq) * head_weights(cfg)


def head_ce_bytes(cfg: dict, batch: int, seq: int, elem: int = 2) -> int:
    """Bytes of the head's cross-entropy of one micro-step: inputs h, W, the
    targets and the loss gradient read once; outputs the per-row loss and
    the hidden state's float32 gradient written once."""
    n, d = head_rows(batch, seq), cfg["dim"]
    return n * d * elem + head_weights(cfg) * elem + n * 4 + n * 4 + n * 4 + n * d * 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over the
    bf16 peak and bytes over the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)

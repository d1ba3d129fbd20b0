"""The plain reference of the cascade stages' training step: a Qwen2-family
decoder LM (RMSNorm pre-norm, half-split rotary embeddings, grouped-query
causal attention, SwiGLU, untied head) with LoRA adapters on the seven
projections of every layer, its mean next-token cross-entropy, the mean of
the micro-batches' gradients, and AdamW over the adapters.

Plain PyTorch in float32 with TF32 off, no kernels, computed layer by layer:
the forward keeps each layer's input only, the loss is taken a sequence at
a time, and the backward recomputes one layer at a time, so that it fits on
the card beside the data. It imports nothing of the program and takes none of
its state: the weights are the benchmark's own (``weights.make``), and a
quantized base is quantized here again from the same bfloat16 weights by
:mod:`.nf4`.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 going forward and its gradient to e5m2 going back, each tensor
scaled by its own absolute maximum, the sums in float32.
"""

from __future__ import annotations

import math

import torch

from . import nf4

KINDS = ("q", "k", "v", "o", "gate", "up", "down")
BIASED = ("q", "k", "v")
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _to_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Reference:
    """The model's float32 weights (the base dequantized where quantized),
    the adapters as float32 leaves, and AdamW's moments."""

    def __init__(self, dims: dict, stage: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: expected 'fp32' or 'fp8'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dims, self.stage = dims, stage
        self.round = _Fp8.apply if precision == "fp8" else (lambda t: t)
        self.embed = weights["embed"]
        self.head = weights["head"].float()
        self.ln_f = weights["ln_f"].float()
        n = dims["layers"]
        self.layers = []
        for i in range(n):
            lw = {"ln1": weights["ln1"][i].float(), "ln2": weights["ln2"][i].float()}
            for k in KINDS:
                w = weights[k][i]
                lw[k] = nf4.dequantize(*nf4.quantize(w)) if stage.get("quant") == "nf4" else w.float()
                if k in BIASED:
                    lw["b" + k] = weights["b" + k][i].float()
            self.layers.append(lw)
        self.lora = {}
        for i in range(n):
            for k in KINDS:
                a = weights["A." + k][i].detach().clone().float().requires_grad_()
                b = torch.zeros((a.shape[1], self.layers[i][k].shape[1]), dtype=torch.float32, device=a.device, requires_grad=True)
                self.lora[f"layers.{i}.{_path(k)}.lora_a"] = a
                self.lora[f"layers.{i}.{_path(k)}.lora_b"] = b
        self.m = {name: torch.zeros_like(p) for name, p in self.lora.items()}
        self.v = {name: torch.zeros_like(p) for name, p in self.lora.items()}
        self.t = 0

    # -- the model -------------------------------------------------------
    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.dims["rms_eps"]) * scale

    def rope(self, x):
        """x [B, L, heads, hd] at positions 0..L-1, half-split convention;
        the angles in float64, then float32."""
        L, hd = x.shape[1], x.shape[3]
        freqs = 1.0 / (self.dims["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
        ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def proj(self, i: int, kind: str, x):
        lw = self.layers[i]
        y = self.mm(x, lw[kind])
        if kind in BIASED:
            y = y + lw["b" + kind]
        a, b = self.lora[f"layers.{i}.{_path(kind)}.lora_a"], self.lora[f"layers.{i}.{_path(kind)}.lora_b"]
        return y + (self.stage["lora_alpha"] / self.dims["lora_rank"]) * self.mm(self.mm(x, a), b)

    def attention(self, q, k, v):
        """Causal softmax attention, query head h reading KV head h // group."""
        B, L, H, hd = q.shape
        group = H // k.shape[2]
        q, k, v = q.transpose(1, 2), k.repeat_interleave(group, dim=2).transpose(1, 2), v.repeat_interleave(group, dim=2).transpose(1, 2)
        s = self.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        return self.mm(p, v).transpose(1, 2).reshape(B, L, H * hd)

    def layer(self, i: int, x):
        d = self.dims
        B, L = x.shape[:2]
        hd = d["dim"] // d["heads"]
        lw = self.layers[i]
        h = self.rms(x, lw["ln1"])
        q = self.rope(self.proj(i, "q", h).reshape(B, L, d["heads"], hd))
        k = self.rope(self.proj(i, "k", h).reshape(B, L, d["kv_heads"], hd))
        v = self.proj(i, "v", h).reshape(B, L, d["kv_heads"], hd)
        x = x + self.proj(i, "o", self.attention(q, k, v))
        h = self.rms(x, lw["ln2"])
        return x + self.proj(i, "down", torch.nn.functional.silu(self.proj(i, "gate", h)) * self.proj(i, "up", h))

    # -- one micro-step's loss and gradients -------------------------------
    def micro_step(self, ids, mask) -> float:
        """Adds this micro-batch's gradient of the mean masked next-token
        loss to the adapters' ``.grad``; returns the loss."""
        B, L = ids.shape
        ids = ids.long()
        m = mask[:, 1:].float()
        count = m.sum().clamp_min(1.0)
        inputs = []
        with torch.no_grad():
            x = self.embed[ids].float()
            for i in range(len(self.layers)):
                inputs.append(x)
                x = self.layer(i, x)
        top = x.requires_grad_()
        hn = self.rms(top, self.ln_f)
        leaf = hn.detach().requires_grad_()
        loss = torch.zeros((), dtype=torch.float64, device=ids.device)
        for b in range(B):  # a sequence at a time: its logits [L - 1, V]
            logits = self.mm(leaf[b, :-1], self.head)
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, ids[b, 1:, None])[:, 0]
            part = (nll * m[b]).sum() / count
            part.backward()
            loss += part.detach().double()
        hn.backward(leaf.grad)
        g = top.grad
        for i in reversed(range(len(self.layers))):
            xi = inputs[i].requires_grad_()
            self.layer(i, xi).backward(g)
            g, inputs[i] = xi.grad, None
        return float(loss)

    def adamw(self, accum: int) -> dict:
        """One AdamW update of the adapters on the mean of ``accum``
        micro-batches' gradients (torch's formula, weight decay as the stage
        sets it); returns the mean gradient's norm by leaf."""
        st = self.stage
        b1, b2 = st["betas"]
        self.t += 1
        norms = {}
        with torch.no_grad():
            for name, p in self.lora.items():
                g = p.grad / accum
                norms[name] = float(g.norm())
                self.m[name].mul_(b1).add_(g, alpha=1 - b1)
                self.v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[name].sqrt() / math.sqrt(1 - b2**self.t)).add_(st["adam_eps"])
                p.mul_(1 - st["lr"] * st["weight_decay"])
                p.addcdiv_(self.m[name], denom, value=-st["lr"] / (1 - b1**self.t))
                p.grad = None
        return norms


def _path(kind: str) -> str:
    return ("attn." if kind in ("q", "k", "v", "o") else "mlp.") + kind


def follow(dims: dict, stage: dict, weights: dict, batches, mask, updates: int, accum: int, precision: str = "fp32") -> dict:
    """The reference's first ``updates`` updates over ``batches`` (micro-batch
    j of update u is ``batches[u * accum + j]``): every micro-step's loss,
    every update's mean gradient norm by leaf (``grads[u][name]``), and the
    change of each adapter leaf after the last (``change[name]``)."""
    ref = Reference(dims, stage, weights, precision)
    start = {name: p.detach().clone() for name, p in ref.lora.items()}
    losses, grads = [], []
    for u in range(updates):
        for j in range(accum):
            losses.append(ref.micro_step(batches[u * accum + j], mask))
        grads.append(ref.adamw(accum))
    change = {name: float((p.detach() - start[name]).norm()) for name, p in ref.lora.items()}
    return {"losses": losses, "grads": grads, "change": change}

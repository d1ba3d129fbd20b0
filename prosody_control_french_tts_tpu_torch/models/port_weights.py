"""HuggingFace checkpoints → this port's modules.

Production users of the reference arrive with published checkpoints
(Qwen2.5-7B for the cascade, Whisper for alignment — QwenA.py:145,
use_whisper_timestamped.py). These converters map a HuggingFace
``state_dict`` (torch tensors or numpy arrays, under HF's names and
layouts) onto the ``state_dict`` of this port's ``models.llm.DecoderLM``
and ``align.whisper.WhisperModel``. No ``transformers`` import is needed:
the converters read names and tensors, and ``llm_config_from_hf`` reads a
config's attributes (HF's config object, or a ``SimpleNamespace`` of a
``config.json``).

Layouts: HF ``Linear`` weights are [out, in], this port's kernels [in, out]
(one transposed copy each); Qwen2's q/k/v carry biases and o does not; a
tied head is the embedding transposed; ``lora_rank > 0`` gives fresh zero
adapters. Whisper's convolutions are [out, in, k] on both sides; its
encoder positions are sinusoidal (computed, not loaded), the decoder's are
learned, and the head is tied to the token embedding, so ``proj_out`` and
``encoder.embed_positions`` are not read. The converted tensors live on the
input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .llm import LLMConfig


def _t(w) -> torch.Tensor:
    return w.detach() if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))


def _same(w, dtype) -> torch.Tensor:
    return _t(w).to(dtype).contiguous()


def _transposed(w, dtype) -> torch.Tensor:
    """[out, in] → [in, out] in ``dtype``: one copy."""
    w = _t(w)
    return torch.empty((w.shape[1], w.shape[0]), dtype=dtype, device=w.device).copy_(w.t())


def _dense(sd, prefix: str, rank: int, bias: bool, dtype) -> dict:
    """HF Linear (+bias) → a ``LoRALinear``'s tensors (fresh zero adapters,
    float32 as the port's adapters always are)."""
    kernel = _transposed(sd[prefix + ".weight"], dtype)
    out = {"kernel": kernel}
    if bias:
        out["bias"] = _same(sd[prefix + ".bias"], dtype)
    if rank > 0:
        in_f, out_f = kernel.shape
        out["lora_a"] = torch.zeros((in_f, rank), dtype=torch.float32, device=kernel.device)
        out["lora_b"] = torch.zeros((rank, out_f), dtype=torch.float32, device=kernel.device)
    return out


def qwen2_to_torch(state_dict: dict, cfg: LLMConfig) -> dict:
    """HF ``Qwen2ForCausalLM`` state_dict → the ``state_dict`` of this port's
    ``DecoderLM(cfg)``, float32 as the JAX package converts (a caller that
    serves in bfloat16 casts the result)."""
    sd = state_dict
    dtype = torch.float32
    r = cfg.lora_rank
    out = {
        "embed.embedding": _same(sd["model.embed_tokens.weight"], dtype),
        "ln_f.scale": _same(sd["model.norm.weight"], dtype),
        # a tied head reads the embedding
        "lm_head.kernel": _transposed(sd.get("lm_head.weight", sd["model.embed_tokens.weight"]), dtype),
    }
    for i in range(cfg.layers):
        pre = f"model.layers.{i}"
        out[f"layers.{i}.ln1.scale"] = _same(sd[f"{pre}.input_layernorm.weight"], dtype)
        out[f"layers.{i}.ln2.scale"] = _same(sd[f"{pre}.post_attention_layernorm.weight"], dtype)
        for part, proj, hf, bias in (
            ("attn", "q", "self_attn.q_proj", True), ("attn", "k", "self_attn.k_proj", True),
            ("attn", "v", "self_attn.v_proj", True), ("attn", "o", "self_attn.o_proj", False),
            ("mlp", "gate", "mlp.gate_proj", False), ("mlp", "up", "mlp.up_proj", False),
            ("mlp", "down", "mlp.down_proj", False),
        ):
            for leaf, t in _dense(sd, f"{pre}.{hf}", r, bias, dtype).items():
                out[f"layers.{i}.{part}.{proj}.{leaf}"] = t
    return out


def llm_config_from_hf(hf_config) -> LLMConfig:
    """The geometry of an HF Qwen2 config (attributes only), float32, no
    adapters."""
    return LLMConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        kv_heads=hf_config.num_key_value_heads,
        ffn=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 1e6),
        dtype=torch.float32,
        lora_rank=0,
    )


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def whisper_to_torch(state_dict: dict, cfg) -> dict:
    """HF ``WhisperForConditionalGeneration`` (or ``WhisperModel``)
    state_dict → the ``state_dict`` of this port's ``align.whisper.
    WhisperModel(cfg)``, float32 (loading casts each tensor to its
    parameter's type)."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    f32 = torch.float32
    out = {}

    def dense(name, hf, bias=True):
        out[name + ".kernel"] = _transposed(sd[hf + ".weight"], f32)
        if bias:
            out[name + ".bias"] = _same(sd[hf + ".bias"], f32)

    def ln(name, hf):
        out[name + ".scale"] = _same(sd[hf + ".weight"], f32)
        out[name + ".bias"] = _same(sd[hf + ".bias"], f32)

    def attn(name, hf):
        dense(name + ".q", hf + ".q_proj")
        dense(name + ".k", hf + ".k_proj", bias=False)
        dense(name + ".v", hf + ".v_proj")
        dense(name + ".out", hf + ".out_proj")

    def block(name, hf, cross: bool):
        attn(name + ".attn", hf + ".self_attn")
        ln(name + ".ln_attn", hf + ".self_attn_layer_norm")
        ln(name + ".ln_ffn", hf + ".final_layer_norm")
        dense(name + ".fc1", hf + ".fc1")
        dense(name + ".fc2", hf + ".fc2")
        if cross:
            attn(name + ".cross", hf + ".encoder_attn")
            ln(name + ".ln_cross", hf + ".encoder_attn_layer_norm")

    for conv in ("conv1", "conv2"):
        out[f"encoder.{conv}.weight"] = _same(sd[f"encoder.{conv}.weight"], f32)
        out[f"encoder.{conv}.bias"] = _same(sd[f"encoder.{conv}.bias"], f32)
    ln("encoder.ln_post", "encoder.layer_norm")
    for i in range(cfg.enc_layers):
        block(f"encoder.blocks.{i}", f"encoder.layers.{i}", cross=False)
    out["decoder.tok_emb.embedding"] = _same(sd["decoder.embed_tokens.weight"], f32)
    out["decoder.pos_emb"] = _same(sd["decoder.embed_positions.weight"], f32)
    ln("decoder.ln_post", "decoder.layer_norm")
    for i in range(cfg.dec_layers):
        block(f"decoder.blocks.{i}", f"decoder.layers.{i}", cross=True)
    return out

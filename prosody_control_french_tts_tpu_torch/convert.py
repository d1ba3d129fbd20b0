"""Carry parameters across from the JAX package to this port.

The measure step has no learned weights: what crosses is the parameter
dataclasses. The functions here read the JAX objects' fields by name, duck-
typed (the JAX package is never imported), and build this port's
dataclasses; a field the port does not know raises, so a parameter can
never be dropped silently.

The LLM's weights cross as trees of numpy arrays keyed as the flax tree is
(``params/layer_i/attn/q/{kernel,bias,lora_a,lora_b}``, ``kernel_q`` /
``kernel_scale`` for quantized trees, ``embed/embedding``, ``ln_f/scale``,
``lm_head/kernel``). Kernels are ``[in, out]`` on both sides, so every leaf
is copied and none is transposed; a leaf the port does not know raises.

The packaged checkpoints cross as ``.npz`` → ``state_dict`` converters:
``masknet_params_from_jax`` for the separator, ``ctc_params_from_jax`` and
``whisper_params_from_jax`` for the acoustic aligners (``masknet_params_to_jax``,
``ctc_params_to_jax`` and ``whisper_params_to_jax`` are the ways back, which
the trainers and checkpoint writers use),
``bert_params_from_jax`` and ``bilstm_params_from_jax`` for the break and
prosody predictors (``bert_params_to_jax`` is the way back: the flat
``a/b/c``-keyed npz the JAX package's checkpoints use), and
``pos_tagger_params_from_jax`` / ``pos_tagger_params_to_jax`` for the
contextual POS tagger. The aligners' flax layouts become the port's: a Conv
kernel ``[k, in, out]`` → ``[out, in, k]``, a DenseGeneral kernel
``[dim, heads, hd]`` → ``[dim, heads·hd]`` and ``[heads, hd, dim]`` →
``[heads·hd, dim]`` (its bias flattened likewise), Dense kernels stay
``[in, out]``, LayerNorm ``scale``/``bias`` and Embed ``embedding`` as they
are. The converters give float32 tensors; loading them into a module casts
each to the module's parameter type (bfloat16 where the flax layer computes
in bfloat16).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .ops.pitch import PitchParams
from .prosody.adjust import ProsodySettings


def _fields_of(obj) -> dict:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return dict(obj)
    return dict(vars(obj))


def _convert(obj, cls):
    values = _fields_of(obj)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    return cls(**values)


def pitch_params_from_jax(obj) -> PitchParams:
    """The port's PitchParams with every field of the JAX ``PitchParams``."""
    return _convert(obj, PitchParams)


def prosody_settings_from_jax(obj) -> ProsodySettings:
    """The port's ProsodySettings with every field of the JAX
    ``ProsodySettings``."""
    return _convert(obj, ProsodySettings)


# ---------------------------------------------------------------------------
# LLM weights
# ---------------------------------------------------------------------------


def _tensor(a) -> torch.Tensor:
    """numpy leaf → torch tensor of the same dtype (bfloat16 numpy arrays,
    which torch cannot read directly, go through their 16-bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


_PROJ_LEAVES = ("kernel", "kernel_q", "kernel_scale", "bias", "lora_a", "lora_b")
_LLM_LEAF = re.compile(
    r"layer_(\d+)/(?:(attn)/(q|k|v|o)|(mlp)/(gate|up|down))/(%s)$|layer_(\d+)/(ln1|ln2)/scale$" % "|".join(_PROJ_LEAVES)
)


def llm_params_from_jax(tree: dict, cfg) -> dict:
    """Flax ``DecoderLM`` tree of numpy arrays (with or without the outer
    ``params``) → the ``state_dict`` of this port's ``DecoderLM(cfg)``."""
    flat = _flatten(tree["params"] if "params" in tree else tree)
    fixed = {"embed/embedding": "embed.embedding", "ln_f/scale": "ln_f.scale", "lm_head/kernel": "lm_head.kernel"}
    out = {}
    for key, val in flat.items():
        m = _LLM_LEAF.match(key)
        if key in fixed:
            name = fixed[key]
        elif m is None:
            raise ValueError(f"llm_params_from_jax: unknown leaf {key!r}")
        elif m.group(7) is not None:
            if int(m.group(7)) >= cfg.layers:
                raise ValueError(f"llm_params_from_jax: {key!r} is beyond the config's {cfg.layers} layers")
            name = f"layers.{m.group(7)}.{m.group(8)}.scale"
        else:
            if int(m.group(1)) >= cfg.layers:
                raise ValueError(f"llm_params_from_jax: {key!r} is beyond the config's {cfg.layers} layers")
            name = f"layers.{m.group(1)}.{m.group(2) or m.group(4)}.{m.group(3) or m.group(5)}.{m.group(6)}"
        out[name] = _tensor(val)
    return out


_FUSED_TOP = ("embed", "ln_f", "lm_head", "layers")
_FUSED_LAYER = ("wqkv", "bqkv", "wo", "wgu", "wdown", "ln1", "ln2")


def fused_params_from_jax(tree: dict) -> dict:
    """The JAX package's fused serving tree of numpy arrays → this port's
    fused tree (``models.llm.fuse_decode_params`` layout; int8 weights stay
    ``{"codes", "scale"}`` dicts)."""

    def weight(w, where):
        if isinstance(w, dict):
            if sorted(w) != ["codes", "scale"]:
                raise ValueError(f"fused_params_from_jax: unknown leaves {sorted(w)} under {where!r}")
            return {"codes": _tensor(w["codes"]), "scale": _tensor(w["scale"])}
        return _tensor(w)

    unknown = sorted(set(tree) - set(_FUSED_TOP))
    if unknown:
        raise ValueError(f"fused_params_from_jax: unknown leaf {unknown}")
    layers = []
    for i, lw in enumerate(tree["layers"]):
        unknown = sorted(set(lw) - set(_FUSED_LAYER))
        if unknown:
            raise ValueError(f"fused_params_from_jax: unknown leaf {unknown} in layer {i}")
        layers.append({k: weight(v, f"layers/{i}/{k}") for k, v in lw.items()})
    return {
        "embed": _tensor(tree["embed"]),
        "ln_f": _tensor(tree["ln_f"]),
        "lm_head": weight(tree["lm_head"], "lm_head"),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# MaskNet (the learned separator of ``denoise: mask``)
# ---------------------------------------------------------------------------

_MASKNET_LEAF = re.compile(r"(Conv|LayerNorm|Dense)_(\d+)/(kernel|bias|scale)$")


def masknet_params_from_jax(tree: dict) -> dict:
    """Flax ``MaskNet`` tree of numpy arrays (``masknet.npz`` as read by
    ``audio.separate.load_params``, with or without the outer ``params``) →
    the ``state_dict`` of this port's ``audio.separate.MaskNet``. Flax conv
    kernels ``[k, in, out]`` become ``[out, in, k]``, the dense kernel
    ``[in, out]`` becomes ``[out, in]``; ``Conv_0`` is the input conv,
    ``Conv_{i+1}`` and ``LayerNorm_i`` the residual block i, the last
    ``LayerNorm`` the output norm. Every leaf is used exactly once: an
    unknown, repeated or missing leaf raises."""
    flat = _flatten(tree["params"] if "params" in tree else tree)
    n_conv = 1 + max((int(m.group(2)) for m in map(_MASKNET_LEAF.match, flat) if m and m.group(1) == "Conv"), default=-1)
    if n_conv < 1:
        raise ValueError("masknet_params_from_jax: no Conv_0 in the tree")
    out = {}
    for key, val in flat.items():
        m = _MASKNET_LEAF.match(key)
        if m is None:
            raise ValueError(f"masknet_params_from_jax: unknown leaf {key!r}")
        kind, i, leaf = m.group(1), int(m.group(2)), m.group(3)
        v = torch.from_numpy(np.asarray(val, np.float32).copy())
        if kind == "Conv" and leaf in ("kernel", "bias"):
            prefix = "conv_in" if i == 0 else f"convs.{i - 1}"
            name, v = (f"{prefix}.weight", v.permute(2, 1, 0).contiguous()) if leaf == "kernel" else (f"{prefix}.bias", v)
        elif kind == "LayerNorm" and leaf in ("scale", "bias"):
            prefix = "norm_out" if i == n_conv - 1 else f"norms.{i}"
            name = f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"
        elif kind == "Dense" and i == 0 and leaf in ("kernel", "bias"):
            name, v = ("dense.weight", v.T.contiguous()) if leaf == "kernel" else ("dense.bias", v)
        else:
            raise ValueError(f"masknet_params_from_jax: unknown leaf {key!r}")
        if name in out:
            raise ValueError(f"masknet_params_from_jax: {key!r} maps onto {name!r} twice")
        out[name] = v
    want = {"conv_in.weight", "conv_in.bias", "norm_out.weight", "norm_out.bias", "dense.weight", "dense.bias"}
    for i in range(n_conv - 1):
        want |= {f"convs.{i}.weight", f"convs.{i}.bias", f"norms.{i}.weight", f"norms.{i}.bias"}
    if set(out) != want:
        raise ValueError(f"masknet_params_from_jax: missing {sorted(want - set(out))}, extra {sorted(set(out) - want)}")
    return out


# ---------------------------------------------------------------------------
# the acoustic aligners (CTC encoder, Whisper encoder-decoder)
# ---------------------------------------------------------------------------


def _aligner_leaf(key: str, kind: str, leaf: str, val) -> torch.Tensor:
    """One flax leaf → the port's layout (see the module docstring)."""
    v = np.array(val, np.float32)
    if kind == "conv" and leaf == "kernel":
        v = v.transpose(2, 1, 0)
    elif kind == "dense_in" and v.ndim == 3:  # [dim, heads, hd]
        v = v.reshape(v.shape[0], -1)
    elif kind == "dense_in" and v.ndim == 2 and leaf == "bias":  # [heads, hd]
        v = v.reshape(-1)
    elif kind == "dense_out" and leaf == "kernel":  # [heads, hd, dim]
        v = v.reshape(-1, v.shape[-1])
    return torch.from_numpy(np.ascontiguousarray(v))


def _put(out: dict, name: str, key: str, v: torch.Tensor, who: str) -> None:
    if name in out:
        raise ValueError(f"{who}: {key!r} maps onto {name!r} twice")
    out[name] = v


_CTC_LEAF = re.compile(
    r"(Conv|LayerNorm|Dense|MultiHeadDotProductAttention)_(\d+)/(?:(query|key|value|out)/)?(kernel|bias|scale)$"
)


def ctc_params_from_jax(tree: dict) -> dict:
    """Flax ``CTCEncoder`` tree of numpy arrays (``ctc_fr_synth.npz`` as read
    by ``align.ctc_aligner.load_params``, with or without the outer
    ``params``) → the ``state_dict`` of this port's ``CTCEncoder``.
    ``Conv_0``/``Conv_1`` are the two convolutions, ``Embed_0`` the
    positions, ``MultiHeadDotProductAttention_i`` layer i's attention,
    ``LayerNorm_2i``/``_2i+1`` and ``Dense_2i``/``_2i+1`` its norms and
    feed-forward, the last LayerNorm and Dense the output. An unknown or
    repeated leaf raises; a missing one fails ``load_state_dict``."""
    who = "ctc_params_from_jax"
    flat = _flatten(tree["params"] if "params" in tree else tree)
    n_layers = len({m.group(2) for m in map(_CTC_LEAF.match, flat) if m and m.group(1) == "MultiHeadDotProductAttention"})
    out = {}
    for key, val in flat.items():
        if key == "Embed_0/embedding":
            _put(out, "pos_emb", key, torch.from_numpy(np.asarray(val, np.float32)), who)
            continue
        m = _CTC_LEAF.match(key)
        if m is None:
            raise ValueError(f"{who}: unknown leaf {key!r}")
        kind, i, proj, leaf = m.group(1), int(m.group(2)), m.group(3), m.group(4)
        if kind == "Conv" and i < 2 and leaf != "scale" and proj is None:
            name, conv = f"conv{i}.{'weight' if leaf == 'kernel' else 'bias'}", "conv"
        elif kind == "MultiHeadDotProductAttention" and proj is not None and leaf != "scale" and i < n_layers:
            name, conv = f"layers.{i}.attn.{proj}.{leaf}", ("dense_out" if proj == "out" else "dense_in")
        elif kind == "LayerNorm" and leaf in ("scale", "bias") and proj is None and i <= 2 * n_layers:
            prefix = "ln_f" if i == 2 * n_layers else f"layers.{i // 2}.ln{1 + i % 2}"
            name, conv = f"{prefix}.{leaf}", "norm"
        elif kind == "Dense" and leaf in ("kernel", "bias") and proj is None and i <= 2 * n_layers:
            prefix = "head" if i == 2 * n_layers else f"layers.{i // 2}.fc{1 + i % 2}"
            name, conv = f"{prefix}.{leaf}", "dense"
        else:
            raise ValueError(f"{who}: unknown leaf {key!r}")
        _put(out, name, key, _aligner_leaf(key, conv, leaf, val), who)
    return out


def _to_jax_leaf(kind: str, leaf: str, v: torch.Tensor, heads: int) -> np.ndarray:
    """One port tensor → its flax layout (the inverse of ``_aligner_leaf``)."""
    a = v.detach().to("cpu", torch.float32).numpy()
    if kind == "conv" and leaf == "kernel":
        a = a.transpose(2, 1, 0)
    elif kind == "dense_in" and leaf == "kernel":  # [dim, heads·hd] → [dim, heads, hd]
        a = a.reshape(a.shape[0], heads, -1)
    elif kind == "dense_in" and leaf == "bias":  # [heads·hd] → [heads, hd]
        a = a.reshape(heads, -1)
    elif kind == "dense_out" and leaf == "kernel":  # [heads·hd, dim] → [heads, hd, dim]
        a = a.reshape(heads, -1, a.shape[-1])
    return np.ascontiguousarray(a)


def _put_jax(out: dict, name: str, key: str, a: np.ndarray, who: str) -> None:
    if "params/" + name in out:
        raise ValueError(f"{who}: {key!r} maps onto {name!r} twice")
    out["params/" + name] = a


_CTC_PORT = re.compile(r"(conv[01])\.(weight|bias)$|pos_emb$|layers\.(\d+)\.(?:attn\.(query|key|value|out)|(ln1|ln2|fc1|fc2))"
                       r"\.(kernel|bias|scale)$|(ln_f|head)\.(kernel|bias|scale)$")


def ctc_params_to_jax(state: dict, heads: int) -> dict:
    """The inverse of ``ctc_params_from_jax``: a port ``CTCEncoder``
    ``state_dict`` → ``{"params/a/b/c": float32 array}`` in the flax layout
    (``heads``: the attention's, for the DenseGeneral kernels). An unknown
    or repeated tensor raises."""
    who = "ctc_params_to_jax"
    n = 1 + max((int(m.group(3)) for m in map(_CTC_PORT.match, state) if m and m.group(3)), default=-1)
    out = {}
    for key, val in state.items():
        m = _CTC_PORT.match(key)
        if m is None:
            raise ValueError(f"{who}: unknown tensor {key!r}")
        conv, cleaf, i, proj, sub, leaf, top, tleaf = m.groups()
        if conv is not None:
            name, kind, leaf = f"Conv_{conv[-1]}/{'kernel' if cleaf == 'weight' else 'bias'}", "conv", (
                "kernel" if cleaf == "weight" else "bias")
        elif key == "pos_emb":
            name, kind, leaf = "Embed_0/embedding", "embed", "embedding"
        elif proj is not None:
            j = {"query": "query", "key": "key", "value": "value", "out": "out"}[proj]
            name, kind = f"MultiHeadDotProductAttention_{i}/{j}/{leaf}", ("dense_out" if proj == "out" else "dense_in")
        elif sub is not None:
            k = 2 * int(i) + (0 if sub in ("ln1", "fc1") else 1)
            name, kind = (f"LayerNorm_{k}/{leaf}", "norm") if sub.startswith("ln") else (f"Dense_{k}/{leaf}", "dense")
        else:
            leaf = tleaf
            name, kind = (f"LayerNorm_{2 * n}/{leaf}", "norm") if top == "ln_f" else (f"Dense_{2 * n}/{leaf}", "dense")
        _put_jax(out, name, key, _to_jax_leaf(kind, leaf, val, heads), who)
    return out


_WHISPER_LEAF = re.compile(
    r"(encoder|decoder)/(?:block_(\d+)/)?"
    r"(conv1|conv2|ln_post|ln_attn|ln_cross|ln_ffn|fc1|fc2|attn|cross|tok_emb)/"
    r"(?:(q|k|v|out)/)?(kernel|bias|scale|embedding)$"
)


def whisper_params_from_jax(tree: dict) -> dict:
    """Flax ``WhisperModel`` tree of numpy arrays (``weights.npz`` of a
    checkpoint directory, with or without the outer ``params``) → the
    ``state_dict`` of this port's ``align.whisper.WhisperModel``:
    ``{encoder,decoder}/block_i/...`` → ``{encoder,decoder}.blocks.i....``,
    the rest by the same names. An unknown or repeated leaf raises; a
    missing one fails ``load_state_dict``."""
    who = "whisper_params_from_jax"
    flat = _flatten(tree["params"] if "params" in tree else tree)
    out = {}
    for key, val in flat.items():
        if key == "decoder/pos_emb":
            _put(out, "decoder.pos_emb", key, torch.from_numpy(np.asarray(val, np.float32)), who)
            continue
        m = _WHISPER_LEAF.match(key)
        if m is None:
            raise ValueError(f"{who}: unknown leaf {key!r}")
        part, blk, layer, proj, leaf = m.groups()
        in_block = layer in ("ln_attn", "ln_cross", "ln_ffn", "fc1", "fc2", "attn", "cross")
        if (blk is not None) != in_block or (proj is not None) != (layer in ("attn", "cross")):
            raise ValueError(f"{who}: unknown leaf {key!r}")
        if layer in ("conv1", "conv2"):
            if part != "encoder" or leaf not in ("kernel", "bias"):
                raise ValueError(f"{who}: unknown leaf {key!r}")
            conv, leaf_name = "conv", ("weight" if leaf == "kernel" else "bias")
        elif layer == "tok_emb":
            if part != "decoder" or leaf != "embedding":
                raise ValueError(f"{who}: unknown leaf {key!r}")
            conv, leaf_name = "embed", leaf
        elif layer.startswith("ln_"):
            if leaf not in ("scale", "bias"):
                raise ValueError(f"{who}: unknown leaf {key!r}")
            conv, leaf_name = "norm", leaf
        else:
            if leaf not in ("kernel", "bias"):
                raise ValueError(f"{who}: unknown leaf {key!r}")
            conv, leaf_name = ("dense_out" if proj == "out" else "dense_in" if proj else "dense"), leaf
        path = [part] + ([f"blocks.{blk}"] if blk is not None else []) + [layer] + ([proj] if proj else []) + [leaf_name]
        _put(out, ".".join(path), key, _aligner_leaf(key, conv, leaf, val), who)
    return out


_WHISPER_PORT = re.compile(
    r"(encoder|decoder)\.(?:blocks\.(\d+)\.)?"
    r"(conv1|conv2|ln_post|ln_attn|ln_cross|ln_ffn|fc1|fc2|attn|cross|tok_emb)\."
    r"(?:(q|k|v|out)\.)?(kernel|bias|scale|weight|embedding)$"
)


def whisper_params_to_jax(state: dict, heads: int) -> dict:
    """The inverse of ``whisper_params_from_jax``: a port ``WhisperModel``
    ``state_dict`` → ``{"params/a/b/c": float32 array}`` in the flax layout
    (``heads``: the config's). An unknown or repeated tensor raises."""
    who = "whisper_params_to_jax"
    out = {}
    for key, val in state.items():
        if key == "decoder.pos_emb":
            _put_jax(out, "decoder/pos_emb", key, val.detach().to("cpu", torch.float32).numpy().copy(), who)
            continue
        m = _WHISPER_PORT.match(key)
        if m is None:
            raise ValueError(f"{who}: unknown tensor {key!r}")
        part, blk, layer, proj, leaf = m.groups()
        if layer in ("conv1", "conv2"):
            kind, leaf = "conv", ("kernel" if leaf == "weight" else leaf)
        elif layer == "tok_emb":
            kind = "embed"
        elif layer.startswith("ln_"):
            kind = "norm"
        else:
            kind = ("dense_out" if proj == "out" else "dense_in") if proj else "dense"
        path = [part] + ([f"block_{blk}"] if blk is not None else []) + [layer] + ([proj] if proj else []) + [leaf]
        _put_jax(out, "/".join(path), key, _to_jax_leaf(kind, leaf, val, heads), who)
    return out


_MASKNET_PORT = re.compile(r"(conv_in|convs\.(\d+)|norms\.(\d+)|norm_out|dense)\.(weight|bias)$")


def masknet_params_to_jax(state: dict) -> dict:
    """The inverse of ``masknet_params_from_jax``: a port ``MaskNet``
    ``state_dict`` → ``{"params/a/b": float32 array}`` in the flax layout
    (conv kernels ``[out, in, k]`` → ``[k, in, out]``, the dense weight
    ``[out, in]`` → ``[in, out]``). An unknown or repeated tensor raises."""
    who = "masknet_params_to_jax"
    n_norms = sum(1 for k in state if re.match(r"norms\.\d+\.weight$", k))
    out = {}
    for key, val in state.items():
        m = _MASKNET_PORT.match(key)
        if m is None:
            raise ValueError(f"{who}: unknown tensor {key!r}")
        mod, ci, ni, leaf = m.groups()
        a = val.detach().to("cpu", torch.float32).numpy()
        if mod == "conv_in" or ci is not None:
            i = 0 if mod == "conv_in" else int(ci) + 1
            name = f"Conv_{i}/{'kernel' if leaf == 'weight' else 'bias'}"
            a = a.transpose(2, 1, 0) if leaf == "weight" else a
        elif ni is not None or mod == "norm_out":
            i = n_norms if mod == "norm_out" else int(ni)
            name = f"LayerNorm_{i}/{'scale' if leaf == 'weight' else 'bias'}"
        else:
            name = f"Dense_0/{'kernel' if leaf == 'weight' else 'bias'}"
            a = a.T if leaf == "weight" else a
        _put_jax(out, name, key, np.ascontiguousarray(a), who)
    return out


# ---------------------------------------------------------------------------
# the break tagger / sentence encoder and the BiLSTM prosody regressor
# ---------------------------------------------------------------------------

_BERT_NAMES = (  # (flax path, port name, leaves, layout); {i} a layer, {leaf} a leaf
    ("encoder/tok_emb/embedding", "encoder.tok_emb", (), "same"),
    ("encoder/pos_emb/embedding", "encoder.pos_emb", (), "same"),
    ("encoder/LayerNorm_0/{leaf}", "encoder.ln_f.{leaf}", ("scale", "bias"), "same"),
    ("encoder/layer_{i}/LayerNorm_0/{leaf}", "encoder.layers.{i}.ln1.{leaf}", ("scale", "bias"), "same"),
    ("encoder/layer_{i}/LayerNorm_1/{leaf}", "encoder.layers.{i}.ln2.{leaf}", ("scale", "bias"), "same"),
    ("encoder/layer_{i}/SelfAttention_0/qkv/{leaf}", "encoder.layers.{i}.attn.qkv.{leaf}", ("kernel", "bias"), "qkv"),
    ("encoder/layer_{i}/SelfAttention_0/out/{leaf}", "encoder.layers.{i}.attn.out.{leaf}", ("kernel", "bias"), "out"),
    ("encoder/layer_{i}/Dense_0/{leaf}", "encoder.layers.{i}.fc1.{leaf}", ("kernel", "bias"), "same"),
    ("encoder/layer_{i}/Dense_1/{leaf}", "encoder.layers.{i}.fc2.{leaf}", ("kernel", "bias"), "same"),
    ("classifier/{leaf}", "classifier.{leaf}", ("kernel", "bias"), "same"),
)


def _name_rx(template: str, leaves) -> re.Pattern:
    rx = re.escape(template).replace(r"\{i\}", r"(?P<i>\d+)").replace(r"\{leaf\}", "(?P<leaf>%s)" % "|".join(leaves))
    return re.compile(rx + "$")


_BERT_FROM = [(_name_rx(j, lv), p, kind) for j, p, lv, kind in _BERT_NAMES]
_BERT_TO = [(_name_rx(p, lv), j, kind) for j, p, lv, kind in _BERT_NAMES]


def _rename(key: str, table, who: str):
    for rx, template, kind in table:
        m = rx.match(key)
        if m:
            return template.format(**m.groupdict()), kind, m.groupdict().get("leaf")
    raise ValueError(f"{who}: unknown leaf {key!r}")


def bert_params_from_jax(tree: dict) -> dict:
    """Flax ``BreakTagger`` or ``SentenceEncoder`` tree of numpy arrays (with
    or without the outer ``params``) → the ``state_dict`` of this port's
    ``models.bert`` module of the same name (float32). The DenseGeneral
    kernels ``qkv [dim, 3, heads, hd]`` and ``out [heads, hd, dim]`` become
    ``[dim, 3·heads·hd]`` and ``[heads·hd, dim]`` (the qkv bias flattened
    likewise); every other leaf keeps its layout (Dense kernels are
    ``[in, out]`` on both sides). An unknown or repeated leaf raises; a
    missing one fails ``load_state_dict``."""
    who = "bert_params_from_jax"
    out = {}
    for key, val in _flatten(tree["params"] if "params" in tree else tree).items():
        name, kind, leaf = _rename(key, _BERT_FROM, who)
        v = np.array(val, np.float32)
        if kind == "qkv":
            v = v.reshape(v.shape[0], -1) if leaf == "kernel" else v.reshape(-1)
        elif kind == "out" and leaf == "kernel":
            v = v.reshape(-1, v.shape[-1])
        _put(out, name, key, torch.from_numpy(np.ascontiguousarray(v)), who)
    return out


def bert_params_to_jax(state: dict, cfg) -> dict:
    """The inverse of ``bert_params_from_jax``: a port ``BreakTagger`` /
    ``SentenceEncoder`` ``state_dict`` → the flat ``{"params/a/b/c": float32
    array}`` dict that ``np.savez`` writes as the JAX package's checkpoints
    are written (``align/ctc_aligner.py:save_params``, read back by its
    ``load_params``). ``cfg`` gives the heads of the DenseGeneral layouts."""
    who = "bert_params_to_jax"
    hd = cfg.hidden // cfg.heads
    out = {}
    for key, val in state.items():
        name, kind, leaf = _rename(key, _BERT_TO, who)
        v = val.detach().to("cpu", torch.float32).numpy()
        if kind == "qkv":
            v = v.reshape(v.shape[0], 3, cfg.heads, hd) if leaf == "kernel" else v.reshape(3, cfg.heads, hd)
        elif kind == "out" and leaf == "kernel":
            v = v.reshape(cfg.heads, hd, v.shape[-1])
        if "params/" + name in out:
            raise ValueError(f"{who}: {key!r} maps onto {name!r} twice")
        out["params/" + name] = np.ascontiguousarray(v)
    return out


_LSTM_GATES = "ifgo"  # flax's OptimizedLSTMCell and nn.LSTM stack the gates in this order
_BILSTM_LEAF = re.compile(r"(fwd|bwd)/cell/(i|h)([ifgo])/(kernel|bias)$|(LayerNorm_0|Dense_0|Dense_1)/(scale|bias|kernel)$")


def bilstm_params_from_jax(tree: dict) -> dict:
    """Flax ``BiLSTMProsody`` tree of numpy arrays (with or without the outer
    ``params``) → the ``state_dict`` of this port's ``BiLSTMProsody``. The
    cell's per-gate leaves ``{fwd,bwd}/cell/{ii,if,ig,io}/kernel [in, H]``
    (no bias) and ``{hi,hf,hg,ho}/{kernel [H, H], bias}`` become
    ``nn.LSTM``'s ``weight_ih_l0[_reverse] [4H, in]``,
    ``weight_hh_l0[_reverse] [4H, H]`` and ``bias_hh_l0[_reverse]``, with
    ``bias_ih`` zero; ``LayerNorm_0`` → ``norm``, ``Dense_0`` / ``Dense_1``
    (kernels ``[in, out]``) → the ``nn.Linear`` layers ``dense`` / ``out``.
    An unknown, repeated or missing leaf raises."""
    who = "bilstm_params_from_jax"
    flat = _flatten(tree["params"] if "params" in tree else tree)
    gates: dict = {}
    out = {}
    for key, val in flat.items():
        m = _BILSTM_LEAF.match(key)
        bad_leaf = m is not None and (m.group(4) == "bias" and m.group(2) == "i" or m.group(5) is not None and (
            m.group(6) == ("kernel" if m.group(5) == "LayerNorm_0" else "scale")))
        if m is None or bad_leaf:
            raise ValueError(f"{who}: unknown leaf {key!r}")
        v = torch.from_numpy(np.array(val, np.float32))
        if m.group(1):
            part = (m.group(1), m.group(2), m.group(4))
            if (part, m.group(3)) in gates:
                raise ValueError(f"{who}: {key!r} twice")
            gates[(part, m.group(3))] = v
        else:
            layer = {"LayerNorm_0": "norm", "Dense_0": "dense", "Dense_1": "out"}[m.group(5)]
            leaf = m.group(6)
            if layer != "norm":
                leaf, v = ("weight", v.T.contiguous()) if leaf == "kernel" else ("bias", v)
            _put(out, f"{layer}.{leaf}", key, v, who)
    for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
        for src, leaf, dst in (("i", "kernel", "weight_ih"), ("h", "kernel", "weight_hh"), ("h", "bias", "bias_hh")):
            parts = [gates.pop(((direction, src, leaf), g), None) for g in _LSTM_GATES]
            if any(p is None for p in parts):
                raise ValueError(f"{who}: {direction}/cell lacks a {src}* {leaf}")
            out[f"lstm.{dst}_l0{sfx}"] = torch.cat([p.T if leaf == "kernel" else p for p in parts]).contiguous()
        out[f"lstm.bias_ih_l0{sfx}"] = torch.zeros_like(out[f"lstm.bias_hh_l0{sfx}"])
    if gates:
        raise ValueError(f"{who}: unknown leaves {sorted(gates)}")
    want = {"norm.scale", "norm.bias", "dense.weight", "dense.bias", "out.weight", "out.bias"}
    if not want <= set(out):
        raise ValueError(f"{who}: missing {sorted(want - set(out))}")
    return out


# ---------------------------------------------------------------------------
# the contextual POS tagger
# ---------------------------------------------------------------------------

_POS_NAMES = (  # (flax path, port name, leaves, layout), as _BERT_NAMES
    ("word_embed/embedding", "word_embed", (), "same"),
    ("char_embed/embedding", "char_embed", (), "same"),
    ("pos_embed", "pos_embed", (), "same"),
    ("block{i}/LayerNorm_0/{leaf}", "blocks.{i}.ln1.{leaf}", ("scale", "bias"), "same"),
    ("block{i}/LayerNorm_1/{leaf}", "blocks.{i}.ln2.{leaf}", ("scale", "bias"), "same"),
    ("block{i}/SelfAttention_0/query/{leaf}", "blocks.{i}.attn.query.{leaf}", ("kernel", "bias"), "heads_in"),
    ("block{i}/SelfAttention_0/key/{leaf}", "blocks.{i}.attn.key.{leaf}", ("kernel", "bias"), "heads_in"),
    ("block{i}/SelfAttention_0/value/{leaf}", "blocks.{i}.attn.value.{leaf}", ("kernel", "bias"), "heads_in"),
    ("block{i}/SelfAttention_0/out/{leaf}", "blocks.{i}.attn.out.{leaf}", ("kernel", "bias"), "out"),
    ("block{i}/Dense_0/{leaf}", "blocks.{i}.fc1.{leaf}", ("kernel", "bias"), "same"),
    ("block{i}/Dense_1/{leaf}", "blocks.{i}.fc2.{leaf}", ("kernel", "bias"), "same"),
    ("LayerNorm_0/{leaf}", "ln_f.{leaf}", ("scale", "bias"), "same"),
    ("out/{leaf}", "out.{leaf}", ("kernel", "bias"), "same"),
)
_POS_FROM = [(_name_rx(j, lv), p, kind) for j, p, lv, kind in _POS_NAMES]
_POS_TO = [(_name_rx(p, lv), j, kind) for j, p, lv, kind in _POS_NAMES]


def pos_tagger_params_from_jax(tree: dict) -> dict:
    """Flax ``PosTagger`` params (a nested tree, with or without the outer
    ``params``, or ``load_tagger``'s flat "/"-keyed arrays) → the
    ``state_dict`` of this port's ``models.pos_tagger.PosTagger`` (float32).
    The attention's DenseGeneral kernels ``query/key/value [d, heads, hd]``
    and ``out [heads, hd, d]`` become ``[d, heads·hd]`` and ``[heads·hd, d]``,
    the ``[heads, hd]`` biases ``[heads·hd]``; every other leaf keeps its
    layout. An unknown or repeated leaf raises; a missing one fails
    ``load_state_dict``."""
    who = "pos_tagger_params_from_jax"
    out = {}
    for key, val in _flatten(tree["params"] if "params" in tree else tree).items():
        name, kind, leaf = _rename(key, _POS_FROM, who)
        v = np.array(val, np.float32)
        if kind == "heads_in":
            v = v.reshape(v.shape[0], -1) if leaf == "kernel" else v.reshape(-1)
        elif kind == "out" and leaf == "kernel":
            v = v.reshape(-1, v.shape[-1])
        _put(out, name, key, torch.from_numpy(np.ascontiguousarray(v)), who)
    return out


def pos_tagger_params_to_jax(state: dict, cfg) -> dict:
    """The inverse of ``pos_tagger_params_from_jax``: a port ``PosTagger``
    ``state_dict`` → the flat ``{"a/b/c": float32 array}`` dict of the JAX
    package's ``save_tagger`` keys (no outer ``params``). ``cfg`` (a
    ``PosTaggerConfig``) gives the heads of the DenseGeneral layouts."""
    who = "pos_tagger_params_to_jax"
    hd = cfg.d_model // cfg.n_heads
    out = {}
    for key, val in state.items():
        name, kind, leaf = _rename(key, _POS_TO, who)
        v = val.detach().to("cpu", torch.float32).numpy()
        if kind == "heads_in":
            v = v.reshape(v.shape[0], cfg.n_heads, hd) if leaf == "kernel" else v.reshape(cfg.n_heads, hd)
        elif kind == "out" and leaf == "kernel":
            v = v.reshape(cfg.n_heads, hd, v.shape[-1])
        if name in out:
            raise ValueError(f"{who}: {key!r} maps onto {name!r} twice")
        out[name] = np.ascontiguousarray(v)
    return out

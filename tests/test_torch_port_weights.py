"""The port's HuggingFace converters (``models/port_weights.py``) against the
JAX package's, and the converted models against HuggingFace's own forward.

Random-initialised HF models built from small configs (no download), as
``tests/test_port_weights.py`` builds them: the converted ``state_dict``
equals the JAX converter's tree carried over by ``convert`` tensor for
tensor, and the port's float32 logits agree with HF's within the
tolerances the JAX suite holds flax to (2e-3 Qwen2, 3e-3 Whisper).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from prosody_control_french_tts_tpu.align import whisper_jax as jwhisper  # noqa: E402
from prosody_control_french_tts_tpu.models import port_weights as jpw  # noqa: E402
from prosody_control_french_tts_tpu_torch import convert  # noqa: E402
from prosody_control_french_tts_tpu_torch.align import whisper as twhisper  # noqa: E402
from prosody_control_french_tts_tpu_torch.models import llm as tllm  # noqa: E402
from prosody_control_french_tts_tpu_torch.models import port_weights as tpw  # noqa: E402

QWEN = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0)
WHISPER = dict(vocab_size=120, num_mel_bins=80, d_model=64, encoder_layers=2, decoder_layers=2,
               encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
               max_source_positions=100, max_target_positions=50, pad_token_id=0, bos_token_id=1, eos_token_id=2,
               decoder_start_token_id=1, suppress_tokens=None, begin_suppress_tokens=None)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def qwen(request):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    hf_cfg = Qwen2Config(**QWEN, tie_word_embeddings=request.param)
    torch.manual_seed(0)
    model = Qwen2ForCausalLM(hf_cfg).eval()
    sd = model.state_dict()
    if request.param:
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    return hf_cfg, model, sd


@pytest.fixture(scope="module")
def whisper():
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    return WhisperForConditionalGeneration(HFWhisperConfig(**WHISPER)).eval()


def test_llm_config_equals_jax(qwen):
    hf_cfg, _, _ = qwen
    got, want = tpw.llm_config_from_hf(hf_cfg), jpw.llm_config_from_hf(hf_cfg)
    fields = {f.name for f in dataclasses.fields(want)} - {"dtype"}
    assert fields <= {f.name for f in dataclasses.fields(got)}
    for name in sorted(fields):
        assert getattr(got, name) == getattr(want, name), name
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # attributes only: a config.json read into a namespace gives the same geometry
    assert tpw.llm_config_from_hf(SimpleNamespace(**hf_cfg.to_dict())) == got


@pytest.mark.parametrize("rank", [0, 8])
def test_qwen2_tree_equals_jax_route(qwen, rank):
    """Tensor for tensor, the JAX converter's tree carried over by
    ``convert.llm_params_from_jax`` (fresh zero adapters at rank 8)."""
    hf_cfg, _, sd = qwen
    tcfg = dataclasses.replace(tpw.llm_config_from_hf(hf_cfg), lora_rank=rank)
    jcfg = dataclasses.replace(jpw.llm_config_from_hf(hf_cfg), lora_rank=rank)
    got = tpw.qwen2_to_torch(sd, tcfg)
    want = convert.llm_params_from_jax(jpw.qwen2_to_flax(sd, jcfg), tcfg)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == torch.float32 and got[name].is_contiguous(), name
        assert torch.equal(got[name], t), name
    assert sorted(got) == sorted(tllm.DecoderLM(tcfg, device="cpu").state_dict())


def test_qwen2_logits_match_hf(qwen):
    """The port's float32 forward of the converted tree against HF's:
    2e-3, the JAX suite's limit for flax (tests/test_port_weights.py:50)."""
    hf_cfg, hf_model, sd = qwen
    cfg = tpw.llm_config_from_hf(hf_cfg)
    model = tllm.DecoderLM(cfg, device="cpu")
    model.load_state_dict(tpw.qwen2_to_torch(sd, cfg), strict=True)
    ids = torch.tensor(np.random.default_rng(0).integers(0, 128, size=(2, 12)))
    with torch.no_grad():
        ref = hf_model(ids).logits
        ours = model(ids)
    torch.testing.assert_close(ours, ref, rtol=2e-3, atol=2e-3)


def test_qwen2_bf16_input_converts_exactly_on_its_device(qwen):
    """A bfloat16 HF tree (as published) converts to float32 without
    rounding, on the input's device, so a cast back to bfloat16 gives HF's
    bits."""
    hf_cfg, _, sd = qwen
    cfg = tpw.llm_config_from_hf(hf_cfg)
    half = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    got = tpw.qwen2_to_torch(half, cfg)
    ref = tpw.qwen2_to_torch(sd, cfg)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.device == half["model.norm.weight"].device, name
        assert torch.equal(t.to(torch.bfloat16), ref[name].to(torch.bfloat16)), name
    assert torch.equal(got["layers.0.attn.k.kernel"].to(torch.bfloat16), half["model.layers.0.self_attn.k_proj.weight"].t())
    # numpy inputs take the same route
    as_np = tpw.qwen2_to_torch({k: v.numpy() for k, v in sd.items()}, cfg)
    assert all(torch.equal(as_np[k], ref[k]) for k in ref)


def _whisper_cfgs():
    geo = dict(n_mels=80, n_audio_ctx=100, n_text_ctx=50, dim=64, heads=4, enc_layers=2, dec_layers=2, vocab_size=120)
    return twhisper.WhisperConfig(**geo, dtype=torch.float32), jwhisper.WhisperConfig(**geo, dtype=jnp.float32)


def test_whisper_tree_equals_jax_route(whisper):
    tcfg, jcfg = _whisper_cfgs()
    sd = whisper.state_dict()
    got = tpw.whisper_to_torch(sd, tcfg)
    want = convert.whisper_params_from_jax(jpw.whisper_to_flax(sd, jcfg))
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    # WhisperModel alone: the same tree without the "model." prefix
    bare = {k.removeprefix("model."): v for k, v in sd.items() if k.startswith("model.")}
    assert all(torch.equal(a, b) for a, b in zip(tpw.whisper_to_torch(bare, tcfg).values(), got.values()))


def test_whisper_logits_match_hf(whisper):
    """The port's float32 model on the converted tree against HF's logits:
    3e-3, the JAX suite's limit for flax (tests/test_port_weights.py:129)."""
    tcfg, _ = _whisper_cfgs()
    model = twhisper.WhisperModel(tcfg)
    model.load_state_dict(tpw.whisper_to_torch(whisper.state_dict(), tcfg), strict=True)
    mel = np.random.default_rng(0).normal(size=(1, 200, 80)).astype(np.float32)  # 200 frames → 100 positions
    toks = torch.tensor([[5, 9, 17, 3]])
    with torch.no_grad():
        ref = whisper(input_features=torch.tensor(mel).transpose(1, 2), decoder_input_ids=toks).logits
        ours, _ = model(torch.tensor(mel), toks)
    torch.testing.assert_close(ours, ref, rtol=3e-3, atol=3e-3)

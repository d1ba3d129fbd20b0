"""The port's training-state checkpoints (``core/checkpoint.py``) and
``train_stage(ckpt_dir=...)`` against the JAX package's: the same step
directories, retention and return values (the files inside differ by
design: ``torch.save`` where the JAX package writes orbax trees), tensors
restored bit for bit onto the template's devices and dtypes, and the
pipeline's step markers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.core import checkpoint as jckpt
from prosody_control_french_tts_tpu_torch.core import checkpoint as tckpt
from prosody_control_french_tts_tpu_torch.models import cascade as tcascade
from prosody_control_french_tts_tpu_torch.models.llm import LLMConfig
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer


def _state(step: int) -> dict:
    g = torch.Generator().manual_seed(step)
    return {
        "params": {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16), "lora_a": torch.randn(3, 2, generator=g)},
        "opt_state": {"exp_avg": [torch.randn(3, generator=g), torch.zeros(2, dtype=torch.float64)], "count": step},
        "step": step,
        "lr": 1e-3,
    }


def _assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want and type(got) is type(want)


def test_save_keep_and_restore_bitwise(tmp_path):
    for step in (1, 2, 3):
        path = tckpt.save_train_state(tmp_path, step, _state(step), keep=2)
        assert path == (tmp_path / f"step_{step:08d}").resolve()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    assert tckpt.latest_checkpoint(tmp_path).name == "step_00000003"
    restored, step = tckpt.restore_train_state(tmp_path, _state(0))
    assert step == 3
    _assert_same(restored, _state(3))
    restored, step = tckpt.restore_train_state(tmp_path, _state(0), step=2)
    assert step == 2
    _assert_same(restored, _state(2))


def test_restore_onto_the_template_dtypes():
    """A leaf takes the template's dtype (and device); leaves the template
    lacks stay as saved."""
    saved = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "extra": torch.ones(2)}, "step": 4}
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}, "step": 0}
    got = tckpt._onto(saved, template)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], saved["params"]["w"].to(torch.bfloat16))
    assert got["params"]["extra"] is saved["params"]["extra"] and got["step"] == 4


def test_missing_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(tmp_path / "nothing", _state(0))
    tckpt.save_train_state(tmp_path, 5, _state(5))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(tmp_path, _state(0), step=4)
    assert tckpt.latest_checkpoint(tmp_path / "nothing") is None


def test_naming_retention_and_return_values_equal_jax(tmp_path):
    """Both packages save steps 1, 2, 3 with keep 2: the same directories
    remain, the same latest, the same restored step and values."""
    jstate = {"params": {"w": jnp.arange(4.0)}}
    tstate = {"params": {"w": torch.arange(4.0)}}
    for step in (1, 2, 3):
        jp = jckpt.save_train_state(tmp_path / "jax", step, jstate, keep=2)
        tp = tckpt.save_train_state(tmp_path / "torch", step, tstate, keep=2)
        assert jp.name == tp.name
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert jckpt.latest_checkpoint(tmp_path / "jax").name == tckpt.latest_checkpoint(tmp_path / "torch").name
    jr, jstep = jckpt.restore_train_state(tmp_path / "jax", jstate)
    tr, tstep = tckpt.restore_train_state(tmp_path / "torch", tstate)
    assert jstep == tstep == 3
    np.testing.assert_array_equal(tr["params"]["w"].numpy(), np.asarray(jr["params"]["w"]))


def test_step_markers_as_jax(tmp_path):
    seen = []
    for mod, d in ((jckpt, tmp_path / "jax"), (tckpt, tmp_path / "torch")):
        m = mod.StepMarkers(d)
        trace = [m.done("align")]
        m.mark("align")
        m.mark("tts_merge")
        trace += [m.done("align"), m.path("align").name, sorted(p.name for p in d.iterdir()),
                  mod.StepMarkers(d, enabled=False).done("align")]
        m.clear()
        trace += [m.done("align"), sorted(p.name for p in d.iterdir())]
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[1][1:3] == [True, "checkpoint_align_done.txt"]


PAIRS = [{"x": s, "y": s.replace(",", " <break/>")} for s in (
    "le chat dort, le chien aussi", "il pleut, nous restons", "elle chante, il danse", "on part demain, si possible",
    "le train arrive, enfin", "tu viens, ou pas",
)]


def test_train_stage_checkpoints_each_epoch(tmp_path):
    """Three epochs with ckpt_keep 2: steps 2 and 3 remain, the newest
    restores to the returned state_dict exactly, and the losses are those
    of a run without checkpoints."""
    texts = [tcascade.format_example(tcascade.TASK_A, p["x"], p["y"]) for p in PAIRS]
    tok = WordPieceTokenizer.train(texts, vocab_size=120, min_freq=1)
    cfg = LLMConfig(vocab_size=len(tok), dim=32, layers=2, heads=4, kv_heads=2, ffn=64, max_len=64, dtype=torch.float32)
    kw = dict(cfg=cfg, epochs=3, batch_size=4, lr=1e-3, seed=1, device="cpu")
    _, params, losses = tcascade.train_stage(PAIRS, tok, ckpt_dir=tmp_path, ckpt_keep=2, **kw)
    _, _, plain_losses = tcascade.train_stage(PAIRS, tok, **kw)
    assert losses == plain_losses and len(losses) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    template = {"params": {k: torch.zeros_like(v) for k, v in params.items()}}
    restored, step = tckpt.restore_train_state(tmp_path, template)
    assert step == 3
    _assert_same(restored["params"], params)
    older, _ = tckpt.restore_train_state(tmp_path, template, step=2)
    assert any(not torch.equal(older["params"][k], v) for k, v in params.items())

"""The PyTorch port's MaskNet separator (``audio/separate.py``, inference)
against the JAX package's, with the packaged checkpoint, on the CPU.

Tolerances, measured here and stated: the mask of ``MaskNet`` on the same
log-magnitudes within 0.02 at most and 1e-3 on average. The convolutions,
the gelu and the residual sums run in bfloat16 on both sides (the port
rounds where XLA does; bit-equal per operation), but the level
normalisation's and the LayerNorms' float32 sums run in another order, and
a last-bit difference there moves a bfloat16 rounding (one bfloat16 step of
a conv output is 2^-8 relative). Measured on the mixtures below (3 s and
12 s at 16 kHz): max |Δmask| 3.1e-3 and 4.4e-3, mean 1.6e-4 and 1.4e-4.
``separate()`` on a 40 s mixture at 44.1 kHz (two chunks, the halo path,
the resampling both ways): the SI-SNR of the port's output against the JAX
output at least 30 dB (measured 49.1 dB), and the output length within ±4
samples of the input's (JAX tests/test_separator.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.audio.separate import PACKAGED_WEIGHTS as JAX_WEIGHTS
from prosody_control_french_tts_tpu.audio.separate import MaskSeparator as JSeparator
from prosody_control_french_tts_tpu.audio.separate import si_snr_db, synth_music
from prosody_control_french_tts_tpu.utils.wavio import Audio as JAudio
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.audio import separate as tsep
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

jstft = importlib.import_module("prosody_control_french_tts_tpu.ops.stft")

MAX_DMASK, MEAN_DMASK = 0.02, 1e-3


@pytest.fixture(scope="module")
def separators():
    return JSeparator(), tsep.MaskSeparator(device="cpu")


def _speech(seconds, rate, seed):
    """Voiced word-like bursts on a moving F0, pauses between."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = 150.0 + 40.0 * np.sin(2 * np.pi * 0.4 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    src = sum(np.sin(h * phase) / h for h in range(1, 11))
    env = np.zeros(n)
    s = 0.1
    while s < seconds - 0.5:
        d = rng.uniform(0.2, 0.5)
        i0, i1 = int(s * rate), int((s + d) * rate)
        env[i0:i1] = np.sin(np.pi * np.linspace(0, 1, i1 - i0)) ** 0.5
        s += d + rng.uniform(0.05, 0.6)
    return (0.3 * env * src).astype(np.float32)


def _mixture(seconds, rate, seed):
    speech = _speech(seconds, rate, seed)
    bed = synth_music(seconds + 0.1, rate, seed=seed + 1)[: speech.size]
    return (speech + 0.3 * bed).astype(np.float32)


def test_packaged_weights_are_the_jax_packages():
    assert tsep.PACKAGED_WEIGHTS.read_bytes() == JAX_WEIGHTS.read_bytes()


def test_every_npz_key_converted_once():
    tree = tsep.load_params(tsep.PACKAGED_WEIGHTS)
    keys = set(np.load(tsep.PACKAGED_WEIGHTS).files)
    assert len(keys) == 18 and all(np.load(tsep.PACKAGED_WEIGHTS)[k].dtype == np.float16 for k in keys)
    state = convert.masknet_params_from_jax(tree)
    model = tsep.MaskNet()
    assert set(state) == set(model.state_dict())
    assert len(state) == len(keys)
    flat = {f"params/{k}": v for k, v in convert._flatten(tree["params"]).items()}
    assert set(flat) == keys
    # each leaf lands once, transposed where the layouts differ
    assert torch.equal(state["conv_in.weight"], torch.from_numpy(flat["params/Conv_0/kernel"]).permute(2, 1, 0))
    assert tuple(state["conv_in.weight"].shape) == (256, 513, 5)
    for i in (1, 2, 3):
        assert torch.equal(state[f"convs.{i - 1}.weight"], torch.from_numpy(flat[f"params/Conv_{i}/kernel"]).permute(2, 1, 0))
        assert torch.equal(state[f"convs.{i - 1}.bias"], torch.from_numpy(flat[f"params/Conv_{i}/bias"]))
    for i in (0, 1, 2):
        assert torch.equal(state[f"norms.{i}.weight"], torch.from_numpy(flat[f"params/LayerNorm_{i}/scale"]))
        assert torch.equal(state[f"norms.{i}.bias"], torch.from_numpy(flat[f"params/LayerNorm_{i}/bias"]))
    assert torch.equal(state["norm_out.weight"], torch.from_numpy(flat["params/LayerNorm_3/scale"]))
    assert torch.equal(state["dense.weight"], torch.from_numpy(flat["params/Dense_0/kernel"]).T)
    assert torch.equal(state["dense.bias"], torch.from_numpy(flat["params/Dense_0/bias"]))


def test_converter_refuses_unknown_and_missing_leaves():
    tree = tsep.load_params(tsep.PACKAGED_WEIGHTS)
    extra = {"params": dict(tree["params"], Dense_1={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(ValueError, match="Dense_1"):
        convert.masknet_params_from_jax(extra)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "LayerNorm_1"}}
    with pytest.raises(ValueError, match="missing"):
        convert.masknet_params_from_jax(missing)


def test_gelu_rounds_as_xla_in_bfloat16():
    import jax

    x = (np.random.default_rng(0).normal(size=20000) * 3).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = tsep.gelu_tanh_bf16(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seconds", [3.0, 12.0])
def test_masknet_matches_jax(separators, seconds):
    js, ts = separators
    mix = _mixture(seconds, 16000, int(seconds))
    spec = np.asarray(jstft.stft(jnp.asarray(mix), 1024, 256))
    logmag = np.log10(np.abs(spec) + 1e-6).T.astype(np.float32)  # [T', 513]
    want = np.asarray(js.model.apply(js.params, jnp.asarray(logmag)))
    with torch.inference_mode():
        got = ts.model(torch.from_numpy(logmag)).numpy()
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert d.max() < MAX_DMASK and d.mean() < MEAN_DMASK, (d.max(), d.mean())


def test_separate_matches_jax_over_two_chunks(separators):
    js, ts = separators
    rate = 44100
    mix = _mixture(40.0, rate, 3)
    want = np.asarray(js.separate(JAudio(mix, rate)).samples, np.float32)
    got = ts.separate(TAudio(mix, rate))
    assert got.rate == rate
    assert abs(got.samples.shape[-1] - mix.shape[-1]) <= 4
    n = min(got.samples.size, want.size)
    assert si_snr_db(np.asarray(got.samples[:n], np.float32), want[:n]) >= 30.0


def test_separate_at_the_checkpoint_rate(separators):
    js, ts = separators
    mix = _mixture(6.0, 16000, 8)
    want = np.asarray(js.separate(JAudio(mix, 16000)).samples, np.float32)
    got = ts.separate(TAudio(mix, 16000)).samples
    assert got.shape == mix.shape
    assert si_snr_db(np.asarray(got, np.float32), want) >= 30.0


def test_separator_without_weights_refuses():
    sep = tsep.MaskSeparator(dim=64, layers=2, device="cpu")
    assert not sep.loaded
    with pytest.raises(ValueError, match="no weights"):
        sep.separate(TAudio(np.zeros(1600, np.float32), 16000))


def test_separator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsep.MaskSeparator()

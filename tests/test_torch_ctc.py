"""The port's CTC aligner against the JAX package's, on the CPU.

- The Viterbi (``ctc_forced_align_plain``, the kernel's plain version):
  states equal and score within 1e-6 relative of ``ctc_forced_align``, on
  tie-heavy log-probs, repeated labels, padded inputs and labels.
- ``CTCEncoder`` with the packaged weights converted, against flax: the two
  round to bfloat16 at the same points, but their float32 LayerNorm and
  softmax sums add in other orders, and a last-bit difference there can
  round a bfloat16 value the other way; over two layers the logits (|.| up
  to ~11) differ by at most 0.05 (measured 0.042) and 0.01 on average
  (measured 0.006) from the module applied op by op. (Under ``jax.jit``
  XLA fuses the bfloat16 chains and rounds less often: the jitted module
  differs from its own op-by-op result by up to 0.06.)
- ``CTCAligner``: the same words, boundaries equal or within one logits
  frame (20 ms), the OOD speech-snap path, ``transcribe``, and the packaged
  checkpoint byte-identical to the JAX package's.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu.align import ctc as jctc
from prosody_control_french_tts_tpu.align.ctc_aligner import CTCAligner as JAligner
from prosody_control_french_tts_tpu.align.pretrain_ctc import PACKAGED_WEIGHTS as J_WEIGHTS
from prosody_control_french_tts_tpu.align.synth_speech import sample_sentences, synth_sentence
from prosody_control_french_tts_tpu.utils.wavio import Audio as JAudio
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.align import ctc as tctc
from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner as TAligner
from prosody_control_french_tts_tpu_torch.align.pretrain_ctc import PACKAGED_WEIGHTS as T_WEIGHTS
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

FRAME_DT = 0.02
TOL_LOGITS_MAX, TOL_LOGITS_MEAN = 0.05, 0.01


@pytest.fixture(scope="module")
def aligners():
    return JAligner(), TAligner(device="cpu")


def _log_probs(T, V, seed, kind):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((T, V)).astype(np.float32) * 2
    if kind == "ties":
        lg = np.round(lg)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(lg), -1))
    if kind == "equal_columns":
        lp[:] = lp[:, :1]
    return lp


# (T, L, input_len, label_len, kind): repeated labels in every case (every
# fifth label repeats the one before it, forbidding the skip)
VITERBI_CASES = [
    (120, 20, 120, 20, "random"),
    (120, 20, 120, 20, "ties"),
    (200, 32, 150, 25, "ties"),
    (200, 32, 60, 32, "random"),
    (64, 40, 64, 40, "random"),  # too few frames: every path at NEG
    (90, 12, 90, 12, "equal_columns"),
    (1, 3, 1, 3, "random"),
    (50, 8, 50, 0, "ties"),
]


@pytest.mark.parametrize("case", VITERBI_CASES)
def test_viterbi_plain_matches_jax(case):
    T, L, il, ll, kind = case
    lp = _log_probs(T, 47, seed=T + L, kind=kind)
    labels = np.random.default_rng(L).integers(1, 6 if kind == "ties" else 47, L).astype(np.int32)
    labels[4::5] = labels[3::5][: len(labels[4::5])]
    js, jscore = jctc.ctc_forced_align(jnp.asarray(lp), jnp.asarray(labels), jnp.int32(il), jnp.int32(ll))
    ts, tscore = tctc.ctc_forced_align_plain(torch.from_numpy(lp), torch.from_numpy(labels), il, ll)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert abs(float(tscore) - float(jscore)) <= 1e-6 * abs(float(jscore))
    # on a CPU tensor the wrapper runs the plain version
    ws, wscore = tctc.ctc_forced_align(torch.from_numpy(lp), torch.from_numpy(labels), il, ll)
    assert torch.equal(ws, ts) and float(wscore) == float(tscore)


@pytest.mark.parametrize("n_valid", [None, 100])
def test_encoder_matches_flax(aligners, n_valid):
    ja, ta = aligners
    mel = np.random.default_rng(0).standard_normal((300, 80)).astype(np.float32) * 0.5
    want = np.asarray(ja.model.apply(ja.params, jnp.asarray(mel), n_valid=n_valid))
    with torch.no_grad():
        got = ta.model(torch.from_numpy(mel), n_valid=n_valid).numpy()
    err = np.abs(got - want)
    if n_valid is not None:
        err = err[:n_valid]
    assert err.max() <= TOL_LOGITS_MAX and err.mean() <= TOL_LOGITS_MEAN, (err.max(), err.mean())


def _words(tg):
    return [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]


def _same_words(want, got, tol=FRAME_DT + 1e-6):
    assert [w for *_, w in got] == [w for *_, w in want]
    for (a0, a1, _), (b0, b1, _) in zip(want, got):
        assert abs(a0 - b0) <= tol and abs(a1 - b1) <= tol, (want, got)


def test_align_matches_jax(aligners):
    ja, ta = aligners
    sents = sample_sentences(3, seed=321_000)
    for i, s in enumerate(sents):
        a, gold = synth_sentence(s, seed=321_000 + i)
        want = _words(ja.align(JAudio(a, 16000), s))
        got = _words(ta.align(TAudio(a, 16000), s))
        _same_words(want, got)
        assert [w for *_, w in got] == s.split()


def test_ood_snap_path_matches_jax(aligners):
    """Noise with a transcript: the Viterbi score is out of distribution and
    the speech-snap post-pass runs on both sides."""
    ja, ta = aligners
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(16000 * 3) * 0.2).astype(np.float32)
    x[16000:20000] = 0.0  # a silence run inside the speech mask
    text = "bonjour et bienvenue dans cette emission"
    labels, _ = ta.vocab.word_spans(text.split())
    n = x.shape[0]
    _, score = ta._align_device(np.pad(x, (0, (1 << max(int(n - 1).bit_length(), 14)) - n)),
                                np.array(labels + [0] * ((-len(labels)) % 32), np.int32), ta._logits_frames(n),
                                len(labels), 0.0)
    assert score / ta._logits_frames(n) < ta.OOD_SCORE_PER_FRAME  # the snap path is taken
    want = _words(ja.align(JAudio(x, 16000), text))
    got = _words(ta.align(TAudio(x, 16000), text))
    assert got == want


def test_transcribe_matches_jax(aligners):
    ja, ta = aligners
    a, _ = synth_sentence("bonjour le monde", seed=3)
    assert ta.transcribe(TAudio(a, 16000)) == ja.transcribe(JAudio(a, 16000))


def test_packaged_weights_are_a_copy():
    assert T_WEIGHTS.read_bytes() == J_WEIGHTS.read_bytes()
    assert hashlib.sha256(T_WEIGHTS.read_bytes()).hexdigest() == hashlib.sha256(J_WEIGHTS.read_bytes()).hexdigest()


def test_converter_refuses_unknown_leaves():
    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import load_params

    tree = load_params(T_WEIGHTS)
    sd = convert.ctc_params_from_jax(tree)
    assert sd["conv0.weight"].shape == (128, 80, 3) and sd["layers.1.attn.out.kernel"].shape == (128, 128)
    tree["params"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.ctc_params_from_jax(tree)

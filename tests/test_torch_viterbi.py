"""Kernel B's plain version (``ops.viterbi.viterbi_path_plain``, through
``ops.pitch.viterbi_batched``) against the JAX package's path finders on
tie-heavy inputs, on the CPU.

Frequencies are powers of two (and 0 and 1,024 Hz, unvoiced), so every jump
cost is an exact multiple of the jump cost in both frameworks, and δ is equal
across candidates (octave cost 0, one strength) or takes three values: many
scores tie exactly. The port keeps the first index of every max, as
``_viterbi_sequential``'s ``argmax`` does; these cases pin that rule, which
the CUDA kernel's argmax tree must keep (it is held to this plain version bit
for bit on the card, ``tests/test_torch_kernels.py``).

``viterbi_pallas_batched`` finds the track by a per-frame argmax of α + β,
not by back-pointers: where several tracks score the same it may take
another one, so it is held equal to the port only where no such tie can
split the track (all frames unvoiced, one candidate, one frame). The inputs
are made with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import pitch as jp
from prosody_control_french_tts_tpu.ops.viterbi_pallas import viterbi_pallas_batched
from prosody_control_french_tts_tpu_torch.ops import pitch as tp

DT = 0.01  # time step: the costs are the parameters' own


def tie_inputs(seed, S, F, K, *, unvoiced=False, equal_strength=True):
    """freq, strength [S, F, K] and intensity [S, F] with exact ties."""
    rng = np.random.default_rng(seed)
    levels = [0, 1024] if unvoiced else [0, 64, 128, 256, 512, 1024]
    freq = rng.choice(np.array(levels, np.float32), size=(S, F, K))
    if equal_strength:
        strength = np.full((S, F, K), 0.5, np.float32)
    else:
        strength = rng.choice(np.array([0.25, 0.5, 0.75], np.float32), size=(S, F, K))
    intensity = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), size=(S, F))
    return freq, strength, intensity


def port_f0(freq, strength, intensity):
    return tp.viterbi_batched(
        torch.from_numpy(freq), torch.from_numpy(strength), torch.from_numpy(intensity), tp.PitchParams(octave_cost=0.0), DT
    ).numpy()


def sequential_f0(freq, strength, intensity):
    p = jp.PitchParams(octave_cost=0.0)
    f = jax.vmap(lambda a, b, c: jp._viterbi_sequential(a, b, c, p, DT))
    return np.asarray(f(jnp.asarray(freq), jnp.asarray(strength), jnp.asarray(intensity)))


def pallas_f0(freq, strength, intensity):
    p = jp.PitchParams(octave_cost=0.0)
    return np.asarray(viterbi_pallas_batched(jnp.asarray(freq), jnp.asarray(strength), jnp.asarray(intensity), p, DT, interpret=True))


@pytest.mark.parametrize("equal_strength", [True, False])
@pytest.mark.parametrize(
    "S,F,K,seed",
    [
        (3, 40, 15, 0),  # the measure path's K
        (2, 1, 15, 1),  # one frame: the last frame's first argmax alone
        (2, 2, 15, 2),  # two frames: one step
        (3, 30, 1, 3),  # one candidate
        (2, 25, 32, 4),  # the largest K the kernel takes
        (4, 64, 16, 5),  # K = 16, a whole tile of frames
    ],
)
def test_plain_equals_sequential_on_tie_heavy_inputs(S, F, K, seed, equal_strength):
    """Every frame equal to ``_viterbi_sequential``'s track, with many exact
    ties between voiced candidates of different frequencies."""
    args = tie_inputs(seed, S, F, K, equal_strength=equal_strength)
    got = port_f0(*args)
    assert got.shape == (S, F)
    np.testing.assert_array_equal(got, sequential_f0(*args))


@pytest.mark.parametrize("S,F,K", [(3, 40, 15), (2, 2, 15), (2, 25, 32)])
def test_all_unvoiced_gives_zeros_in_every_path_finder(S, F, K):
    """All frames unvoiced (0 Hz or above the ceiling), δ equal across
    candidates: the port, the sequential scan and the Pallas kernel all give
    0 Hz everywhere."""
    args = tie_inputs(10 + K, S, F, K, unvoiced=True)
    got = port_f0(*args)
    np.testing.assert_array_equal(got, np.zeros((S, F), np.float32))
    np.testing.assert_array_equal(got, sequential_f0(*args))
    np.testing.assert_array_equal(got, pallas_f0(*args))


@pytest.mark.parametrize("S,F,K", [(3, 30, 1), (2, 1, 15), (4, 1, 32)])
def test_plain_equals_pallas_where_no_tie_splits_the_track(S, F, K):
    """One candidate, or one frame (the first argmax of δ): the Pallas
    kernel's track equals the port's and the sequential scan's."""
    args = tie_inputs(20 + F + K, S, F, K, equal_strength=False)
    got = port_f0(*args)
    np.testing.assert_array_equal(got, pallas_f0(*args))
    np.testing.assert_array_equal(got, sequential_f0(*args))

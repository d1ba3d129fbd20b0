"""The whole measure-and-SSML slice: the PyTorch port against the JAX
package on one synthetic voice (three segments of 1–2 s, made from a seed).

Tolerances: per-syntagme and per-segment F0 medians within 1e-3 relative
(the FFTs of the two sides round differently in the last bits, which can
move a near-tie in the path); LUFS within 0.01 dB (sums in another order);
raw_rate within 1e-5 (durations and word counts, no DSP); smoothed
percentages within 0.05 points.
"""

import csv
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline
from prosody_control_french_tts_tpu.ops.pitch import PitchParams as JPitchParams
from prosody_control_french_tts_tpu.prosody import adjust as ja, measure as jm
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.core import pipeline as tpipe
from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams
from prosody_control_french_tts_tpu_torch.prosody import adjust as ta, measure as tm
from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

VOICE = "fr-FR-DeniseNeural"


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    root = tmp_path_factory.mktemp("voice")
    seg_files, tg_dir, raw_dir = synth_voice(root, seed=0, n_segments=3, seconds=(1.0, 2.0))
    return root, seg_files, tg_dir, raw_dir


@pytest.fixture(scope="module")
def both(voice):
    """(port result, JAX result, port device outputs, JAX device outputs)."""
    _, seg_files, tg_dir, raw_dir = voice
    st_j = ja.ProsodySettings()
    st_t = convert.prosody_settings_from_jax(st_j)
    prep_j = jm.prepare_voice(seg_files, tg_dir, raw_dir, st_j)
    prep_t = tm.prepare_voice(seg_files, tg_dir, raw_dir, st_t)
    out_j = jm.run_measure_device(prep_j, JPitchParams())
    out_t = tm.run_measure_device(prep_t, PitchParams(), device="cpu")
    res_j = jm.postprocess_voice(prep_j, out_j, st_j)
    res_t = tm.postprocess_voice(prep_t, out_t, st_t)
    return res_t, res_j, out_t, out_j, prep_t, prep_j


def test_prepared_voice_matches(both):
    """Host preparation is a copy: the same corpus bytes and windows."""
    *_, prep_t, prep_j = both
    assert prep_t.nat.shape[1] == prep_j.nat.shape[1] == tm.bucket_length(int(prep_t.nat_len.max()))
    np.testing.assert_array_equal(np.asarray(prep_t.nat), np.asarray(prep_j.nat))
    np.testing.assert_array_equal(prep_t.nat_len, prep_j.nat_len)
    np.testing.assert_array_equal(np.asarray(prep_t.raw_for_device), np.asarray(prep_j.raw_for_device))
    np.testing.assert_array_equal(prep_t.win_nat, prep_j.win_nat)
    np.testing.assert_array_equal(prep_t.win_raw_dev, prep_j.win_raw_dev)
    np.testing.assert_array_equal(prep_t.mask, prep_j.mask)


def test_device_outputs_match(both):
    """F0 medians within 1e-3 relative; LUFS within 0.01 dB."""
    _, _, out_t, out_j, prep_t, _ = both
    mask = prep_t.mask
    p_syn_t, p_seg_t, *l_t = out_t
    p_syn_j, p_seg_j, *l_j = (np.asarray(a) for a in out_j)
    np.testing.assert_allclose(p_syn_t[mask], p_syn_j[mask], rtol=1e-3, atol=0)
    np.testing.assert_allclose(p_seg_t, p_seg_j, rtol=1e-3, atol=0)
    assert (p_seg_t > 0).all()
    for a, b in zip(l_t, l_j):
        a, b = np.asarray(a), np.asarray(b)
        sel = mask if a.ndim == 2 else slice(None)
        np.testing.assert_allclose(a[sel], b[sel], rtol=0, atol=0.01)
        assert np.isfinite(a[sel]).all()


def test_measure_result_matches(both):
    res_t, res_j, *_ = both
    assert len(res_t.rows) == len(res_j.rows) > 3
    for rt, rj in zip(res_t.rows, res_j.rows):
        assert (rt.segment, rt.syntagme, rt.pause) == (rj.segment, rj.syntagme, rj.pause)
        assert abs(rt.raw_rate - rj.raw_rate) <= 1e-5
        assert abs(rt.rate_smooth - rj.rate_smooth) <= 0.05
        assert abs(rt.pitch_smooth - rj.pitch_smooth) <= 0.05
        assert abs(rt.raw_pitch - rj.raw_pitch) <= 0.05
        assert abs(rt.raw_volume - rj.raw_volume) <= 0.05
    for st, sj in zip(res_t.seg_stats, res_j.seg_stats):
        assert abs(st.p_nat - sj.p_nat) <= 1e-3 * sj.p_nat
        assert abs(st.l_nat - sj.l_nat) <= 0.01 and abs(st.l_syn - sj.l_syn) <= 0.01
        assert (st.d_nat, st.d_syn, st.wc) == (sj.d_nat, sj.d_syn, sj.wc)
        assert abs(st.rate_ratio - sj.rate_ratio) <= 1e-9
    for k in ("f0", "loud", "rate"):
        np.testing.assert_allclose(res_t.baselines[k], res_j.baselines[k], rtol=1e-3)


def test_measure_voice_entry_point(voice, both):
    """The public entry point gives the result of its three phases."""
    _, seg_files, tg_dir, raw_dir = voice
    res = tm.measure_voice(seg_files, tg_dir, raw_dir, ta.ProsodySettings(), device="cpu")
    assert [r.pitch_smooth for r in res.rows] == [r.pitch_smooth for r in both[0].rows]


def test_missing_raw_file_falls_back_like_jax(voice, tmp_path):
    """A segment without a raw rendering is measured on its natural slice,
    as in the reference; the rows equal the JAX package's within the
    tolerances above."""
    import shutil

    _, seg_files, tg_dir, raw_dir = voice
    raw2 = tmp_path / "raw"
    shutil.copytree(raw_dir, raw2)
    (raw2 / f"{seg_files[1].stem}.wav").unlink()
    res_j = jm.measure_voice(seg_files, tg_dir, raw2, ja.ProsodySettings())
    res_t = tm.measure_voice(seg_files, tg_dir, raw2, ta.ProsodySettings(), device="cpu")
    assert len(res_t.rows) == len(res_j.rows)
    for rt, rj in zip(res_t.rows, res_j.rows):
        assert abs(rt.raw_rate - rj.raw_rate) <= 1e-5
        assert abs(rt.raw_volume - rj.raw_volume) <= 0.05
        assert abs(rt.pitch_smooth - rj.pitch_smooth) <= 0.05
    assert res_t.seg_stats[1].d_syn == res_t.seg_stats[1].d_nat


def _jax_render(result, results_dir, factor):
    """The JAX package's emit_measure_csvs on a stand-in pipeline object."""
    results_dir.mkdir(parents=True, exist_ok=True)
    fake = SimpleNamespace(
        cfg=SimpleNamespace(azure_voice_name=VOICE, prosody=SimpleNamespace(inter_syntagme_pause_factor=factor)),
        bdd_ssml_csv=results_dir / "BDD_ssml.csv",
        bdd_syntagme_ssml_csv=results_dir / "BDD_syntagme_ssml.csv",
        bdd_syntagme_synth_csv=results_dir / "BDD_syntagme_for_synth.csv",
    )
    AudioPipeline.emit_measure_csvs(fake, result)


@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_csvs_byte_equal_from_one_result(both, tmp_path, factor):
    """One MeasureResult rendered by the port and by the JAX package gives
    byte-equal CSVs."""
    res_t = both[0]
    tpipe.emit_measure_csvs(res_t, tmp_path / "port", VOICE, factor)
    _jax_render(res_t, tmp_path / "jax", factor)
    for name in tpipe.CSV_NAMES:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


_BREAK = re.compile(r"<break[^>]*>")


def _fields(path):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [
        (r["segment"], r.get("syntagme"), r.get("pause"), _BREAK.findall(r["ssml"]), re.sub(r"<[^>]+>", "", r["ssml"]))
        for r in rows
    ]


def test_csvs_from_audio_match_jax(voice, both, tmp_path):
    """measure_and_build_ssml from audio: text, pause and <break> fields of
    all three CSVs equal the JAX package's."""
    _, seg_files, tg_dir, raw_dir = voice
    res = tpipe.measure_and_build_ssml(
        seg_files, tg_dir, raw_dir, tmp_path / "port", ta.ProsodySettings(), VOICE, 1.0, device="cpu"
    )
    assert len(res.rows) == len(both[1].rows)
    _jax_render(both[1], tmp_path / "jax", 1.0)
    for name in tpipe.CSV_NAMES:
        assert _fields(tmp_path / "port" / name) == _fields(tmp_path / "jax" / name), name


def test_adjust_math_matches_jax():
    """The clamp/smooth math on the same float32 inputs: within 1e-4 points
    (float32 transcendental functions of two libraries)."""
    rng = np.random.default_rng(0)
    n = 40
    p = np.where(rng.random(n) < 0.8, rng.uniform(90, 300, n), 0).astype(np.float32)
    base = np.full(n, 170.0, np.float32)
    loud = rng.uniform(-30, -15, n).astype(np.float32)
    wc = rng.integers(0, 6, n).astype(np.float32)
    dn = rng.uniform(0.1, 7, n).astype(np.float32)
    ds = rng.uniform(0.1, 7, n).astype(np.float32)
    s = ja.ProsodySettings()
    T = torch.from_numpy
    pairs = [
        (ta.pitch_adjust_pct(T(p), T(base), 2.0, 0.7), ja.pitch_adjust_pct(jnp.asarray(p), jnp.asarray(base), 2.0, 0.7)),
        (ta.volume_adjust_pct(T(np.full(n, -20, np.float32)), T(loud), 7.0), ja.volume_adjust_pct(jnp.full(n, -20.0), jnp.asarray(loud), 7.0)),
        (ta.rate_adjust_pct(T(wc), T(dn), T(ds), ta.ProsodySettings()), ja.rate_adjust_pct(jnp.asarray(wc), jnp.asarray(dn), jnp.asarray(ds), s)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    x = rng.uniform(-15, 15, n).astype(np.float32)
    np.testing.assert_allclose(ta.smooth_series(x, 0.4, 5.0).numpy(), np.asarray(ja.smooth_series(x, 0.4, 5.0)), rtol=0, atol=1e-5)
    b_t = ta.segment_baselines(p[:7], loud[:7], dn[:7], 3)
    b_j = ja.segment_baselines(p[:7], loud[:7], dn[:7], 3)
    for k in b_j:
        np.testing.assert_array_equal(b_t[k], b_j[k])


@pytest.mark.parametrize("n", [0, 1, 24576, 24577, 500000, 1040384, 1040385])
def test_bucket_length_kept(n):
    assert tm.bucket_length(n) == jm.bucket_length(n)


class TestConvert:
    def test_pitch_params_carry_every_field(self):
        src = JPitchParams(floor=75.0, ceiling=500.0, time_step=0.01, max_candidates=12, octave_cost=0.02)
        got = convert.pitch_params_from_jax(src)
        assert isinstance(got, PitchParams)
        assert vars(got) == vars(src)

    def test_prosody_settings_carry_every_field(self):
        src = ja.ProsodySettings(pitch_semitones=3.0, volume_pct=5.0, baseline_window=3, slow_floor_per_sec=1.0)
        got = convert.prosody_settings_from_jax(src)
        assert isinstance(got, ta.ProsodySettings)
        assert vars(got) == vars(src)

    def test_unknown_field_raises(self):
        with pytest.raises(ValueError, match="no field"):
            convert.pitch_params_from_jax(SimpleNamespace(floor=100.0, new_knob=1))
        with pytest.raises(ValueError, match="no field"):
            convert.prosody_settings_from_jax({"volume_pct": 3.0, "unknown": 2})

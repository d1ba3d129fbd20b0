"""The port's production data mesh (``parallel.mesh.production_data_mesh``):
the measure path splits its segment rows over the mesh's devices and gives
the rows of the single-device path. Port of the JAX package's
tests/test_production_mesh.py; ``PCFT_DATA_MESH=4`` gives four slots on the
one CPU device, where the JAX tests use the conftest's virtual devices.
"""

import contextlib

import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams
from prosody_control_french_tts_tpu_torch.parallel.mesh import production_data_mesh
from prosody_control_french_tts_tpu_torch.prosody import measure as tm
from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend
from prosody_control_french_tts_tpu_torch.utils import wavio
from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice
from prosody_control_french_tts_tpu_torch.utils.textgridio import word_tier_with_silences, write_textgrid


def _synth_batch():
    """tests/test_production_mesh.py's batch: S 3, T 16,384."""
    rng = np.random.default_rng(0)
    sr = 22050
    S, T, N = 3, 1 << 14, 4
    t = np.arange(T) / sr
    nat = np.stack([(0.4 * np.sin(2 * np.pi * f * t) * (rng.random(T) < 0.97)).astype(np.float32) for f in (180.0, 220.0, 260.0)])
    lens = np.array([T, T - 1500, T - 3000], np.int32)
    for i, n in enumerate(lens):
        nat[i, n:] = 0
    win = np.zeros((S, N, 2), np.int32)
    mask = np.zeros((S, N), bool)
    for i in range(S):
        step = int(lens[i]) // N
        for j in range(N):
            win[i, j] = (j * step, (j + 1) * step)
            mask[i, j] = True
    return sr, nat, lens, win, mask


def _fake_prep(nat, lens, win, mask, sr):
    S = nat.shape[0]
    return tm.PreparedVoice(
        names=[f"seg{i}" for i in range(S)], raw_seqs=[[] for _ in range(S)], synts_per_seg=[[] for _ in range(S)],
        nat=nat, nat_len=lens, rate=sr, raw_ok=np.ones(S, bool), raw_len=lens, raw_for_device=nat, raw_len_dev=lens,
        win_nat=win, win_raw=win, win_raw_dev=win, mask=mask, raw_slice_empty=np.zeros_like(mask),
    )


@contextlib.contextmanager
def one_thread():
    """Each row's arithmetic is the same on the mesh; on several threads the
    CPU's reductions split their work by the batch's size, so the bit-for-bit
    comparisons run on one thread (as the ranks of
    tests/test_torch_distributed.py do)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_single_slot_passthrough(monkeypatch):
    """``0`` disables, and so does the CPU's default; one slot is no mesh."""
    monkeypatch.delenv("PCFT_DATA_MESH", raising=False)
    assert production_data_mesh("cpu") is None
    for env in ("0", "1"):
        monkeypatch.setenv("PCFT_DATA_MESH", env)
        assert production_data_mesh("cpu") is None


def test_slots_pad_the_segment_axis(monkeypatch):
    """S 3 over four slots: one row each, the fourth a padded zero row;
    the packed rows read back are S."""
    monkeypatch.setenv("PCFT_DATA_MESH", "4")
    slots = production_data_mesh("cpu")
    assert slots == [torch.device("cpu")] * 4
    sr, nat, lens, win, mask = _synth_batch()
    g = tm._pack_group([(None, _fake_prep(nat, lens, win, mask, sr))], torch.device("cpu"))
    parts = tm._measure_on_slots(g, float(sr), PitchParams(), slots)
    assert [p.shape[0] for p in parts] == [1, 1, 1, 1]
    assert tm._read_rows(parts, 3).shape[0] == 3
    assert np.isfinite(parts[-1].numpy()).all()  # the zero-length row


def test_run_measure_device_rows_equal_on_the_mesh(monkeypatch):
    """run_measure_device under PCFT_DATA_MESH=4 gives the bits of the
    single-device pass (on one thread)."""
    sr, nat, lens, win, mask = _synth_batch()
    prep = _fake_prep(nat, lens, win, mask, sr)
    out = {}
    with one_thread():
        for env in ("0", "4"):
            monkeypatch.setenv("PCFT_DATA_MESH", env)
            out[env] = tm.run_measure_device(prep, PitchParams(), device="cpu")
    for a, b in zip(out["0"], out["4"]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_measure_step_csvs_identical_on_the_mesh(tmp_path, monkeypatch):
    """The pipeline's Measure & Build SSML step writes byte-identical CSVs
    whether the corpus batch is split over four slots or kept whole (on one
    thread)."""
    SR = 44100
    segments = {
        "segment_ph1": [("bonjour", 0), ("le", 0), ("monde.", 400), ("merci", 0)],
        "segment_ph2": [("la", 0), ("voix", 300), ("change.", 0)],
    }
    csvs = {}
    for tag, mesh_env in (("single", "0"), ("mesh", "4")):
        monkeypatch.setenv("PCFT_DATA_MESH", mesh_env)
        base = tmp_path / tag
        name = "v"
        vdir = base / "Data" / "voice" / name
        (vdir / "audio").mkdir(parents=True)
        (vdir / "transcription_raw").mkdir(parents=True)
        tg_dir = vdir / "WhisperTS_textgrid_files"
        tg_dir.mkdir(parents=True)
        gen = FakeBackend(seed=7)
        for seg, wp in segments.items():
            chunks, times, cursor = [], [], 0.0
            for word, pause_ms in wp:
                a = gen._voice(word, pitch_pct=5.0, rate_pct=0.0, volume_pct=0.0)
                times.append((cursor, cursor + len(a) / SR, word))
                cursor += len(a) / SR
                chunks.append(a)
                if pause_ms:
                    chunks.append(np.zeros(int(pause_ms * SR / 1000)))
                    cursor += pause_ms / 1000.0
            x = np.concatenate(chunks)
            wavio.write_wav(vdir / "audio" / f"{seg}.wav", x, SR)
            write_textgrid(word_tier_with_silences(times, total_duration=len(x) / SR), tg_dir / f"{seg}.TextGrid")
            (vdir / "transcription_raw" / f"{seg}.txt").write_text(" ".join(w for w, _ in wp), encoding="utf-8")
        cfg = PipelineConfig.from_dict(
            {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": [name], "tts_backend": "fake", "aligner": "precomputed"},
            base,
        )
        pipe = AudioPipeline(name, cfg, tts=FakeBackend(seed=1), device="cpu")
        pipe.raw_synthesis()
        with one_thread():
            pipe.measure_prosody_and_build_ssml()
        csvs[tag] = {p.name: p.read_bytes() for p in sorted((base / "Out" / "results" / name).glob("*.csv"))}
    assert "BDD_ssml.csv" in csvs["single"]
    assert csvs["single"] == csvs["mesh"]


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    settings = ProsodySettings()
    preps = {}
    for name, seed, n in (("a", 0, 3), ("b", 5, 2)):
        preps[name] = tm.prepare_voice(*synth_voice(root / name, seed=seed, n_segments=n, seconds=(1.0, 2.0)), settings)
    assert len({(p.nat.shape[1], p.rate) for p in preps.values()}) == 1  # one group of 5 segments
    return settings, preps


@pytest.mark.parametrize("mesh_env", ["0", "4"])
def test_measure_voices_batched_matches_per_voice(voices, monkeypatch, mesh_env):
    """Every voice's rows and segment statistics from the batched pass,
    with the group's 5 segments split over four slots (8 rows, 3 padded) or
    kept whole, equal those of the per-voice pass without the mesh (on one
    thread)."""
    settings, preps = voices
    with one_thread():
        monkeypatch.setenv("PCFT_DATA_MESH", "0")
        solo = {n: tm.postprocess_voice(p, tm.run_measure_device(p, PitchParams(), device="cpu"), settings) for n, p in preps.items()}
        monkeypatch.setenv("PCFT_DATA_MESH", mesh_env)
        got = tm.measure_voices_batched(preps, settings, device="cpu")
    for name, res in solo.items():
        assert len(got[name].rows) == len(res.rows) > 0
        assert got[name].rows == res.rows
        assert got[name].seg_stats == res.seg_stats


def test_each_slot_measures_with_its_device_current(monkeypatch):
    """Every slot's rows are cut, measured and packed inside a scope that
    makes the slot's device current (``ops.kernels.on_device``): kernels
    launch on the current card, so a slot on another card must be made
    current first. One scope per slot and group, and no pass outside one."""
    monkeypatch.setenv("PCFT_DATA_MESH", "4")
    scopes, inside, calls = [], [], []

    @contextlib.contextmanager
    def recording(dev):
        scopes.append(dev)
        inside.append(dev)
        try:
            yield
        finally:
            inside.pop()

    def watched(fn):
        def call(x, *a, **k):
            calls.append((inside[-1] if inside else None, x.device))
            return fn(x, *a, **k)

        return call

    monkeypatch.setattr(tm, "on_device", recording)
    monkeypatch.setattr(tm, "measure_nat", watched(tm.measure_nat))
    monkeypatch.setattr(tm, "measure_raw", watched(tm.measure_raw))
    sr, nat, lens, win, mask = _synth_batch()
    tm.run_measure_device(_fake_prep(nat, lens, win, mask, sr), PitchParams(), device="cpu")
    assert scopes == [torch.device("cpu")] * 4
    assert len(calls) == 8 and all(scope == dev for scope, dev in calls)


def test_a_kernel_refuses_an_input_off_the_current_card(monkeypatch):
    """``ops.kernels.stream_ptr`` raises for a tensor on a card that is not
    the current one, before it reads any stream."""
    from types import SimpleNamespace

    from prosody_control_french_tts_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="cuda:1 while cuda:0 is current"):
        kernels.stream_ptr(SimpleNamespace(device=torch.device("cuda", 1)))

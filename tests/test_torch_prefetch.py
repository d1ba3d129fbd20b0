"""The corpus prefetch of the port's pipeline (``prosody.measure``:
``prefetch_corpus``, ``prefetch_segment``, ``_assemble_from_segments``,
``_load_padded_cached``), on the CPU, where an entry holds the host arrays.

- A full pipeline run (a brute recording of two synthetic segments,
  Preprocess through Compare Breaks, fake TTS, energy aligner) takes two
  hits (the natural and the raw corpus), the raw one assembled from its
  resident segment rows bit for bit as the host loads it; its CSVs are
  byte-equal to a ``measure_and_build_ssml`` run on the same files with an
  empty cache, and to the JAX pipeline's on the same recording. Two voices
  through the multi-voice runner take four hits.
- A rewritten segment misses; the caps (16 corpora, 64 segments) evict the
  oldest; under ``PCFT_DATA_MESH=2`` no corpus is assembled or kept on a
  device; a resampled corpus is not assembled; a corpus whose shape or
  dtype no longer matches is uploaded anew.
- An error while uploading propagates (no fallback), while a file that the
  JAX package declines to prefetch by its format is declined here too.
"""

import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu_torch.core import batch_runner
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import CSV_NAMES, AudioPipeline, measure_and_build_ssml
from prosody_control_french_tts_tpu_torch.prosody import measure as tm
from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend
from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice
from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid
from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav, resample, write_wav

PREFETCH = tm.PREFETCH


@pytest.fixture(autouse=True)
def empty_cache(monkeypatch):
    monkeypatch.delenv("PCFT_DATA_MESH", raising=False)
    PREFETCH.clear()
    yield
    PREFETCH.clear()


def config(names) -> dict:
    return {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": list(names), "tts_backend": "fake",
            "aligner": "energy", "azure_voice_name": "fr-FR-DeniseNeural",
            "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300}}


def brute_voice(base, name: str, seed: int) -> list[str]:
    """Two synthetic segments of 2–3.5 s joined by 1.5 s of zeros into
    ``Data/voice/<name>/brute/segment.wav``; returns their transcripts."""
    seg_files, tg_dir, _ = synth_voice(base / f"synth_{name}", seed=seed, n_segments=2, seconds=(2.0, 3.5))
    parts, texts = [], []
    for p in seg_files:
        a = read_wav(p)
        parts += [np.asarray(a.samples, np.float32), np.zeros(int(1.5 * a.rate), np.float32)]
        texts.append(" ".join(iv.mark.strip() for iv in read_textgrid(tg_dir / f"{p.stem}.TextGrid").tiers[0] if iv.mark.strip()))
    brute = base / "Data" / "voice" / name / "brute"
    brute.mkdir(parents=True)
    write_wav(brute / "segment.wav", np.concatenate(parts[:-1]), a.rate)
    return texts


def write_transcripts(voice_dir, texts) -> None:
    segs = sorted((voice_dir / "audio").glob("*.wav"), key=tm.segment_sort_key)
    assert len(segs) == len(texts)
    (voice_dir / "transcription_raw").mkdir(parents=True, exist_ok=True)
    for seg, text in zip(segs, texts):
        (voice_dir / "transcription_raw" / f"{seg.stem}.txt").write_text(text, encoding="utf-8")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's pipeline and the JAX one on the same brute recording, all
    eight steps; the port's prefetch counters and entries read after it."""
    tbase, jbase = tmp_path_factory.mktemp("prefetch_torch"), tmp_path_factory.mktemp("prefetch_jax")
    texts = brute_voice(tbase, "pv", 0)
    brute_voice(jbase, "pv", 0)
    PREFETCH.clear()
    pipe = AudioPipeline("pv", PipelineConfig.from_dict(config(["pv"]), tbase), tts=FakeBackend(), device="cpu")
    jpipe = JPipeline("pv", JConfig.from_dict(config(["pv"]), jbase), tts=JFake())
    for p in (pipe, jpipe):
        p.cfg.steps_to_run = ["Preprocess"]
        p.run()
        write_transcripts(p.voice_dir, texts)
        p.cfg.steps_to_run = AudioPipeline.STEP_NAMES[1:]
    entries = {}

    def spy_measure():
        # the cache as the measure step finds it
        entries.update(corpora=dict(PREFETCH.corpora), segments=dict(PREFETCH.segments),
                       counts=(PREFETCH.hits, PREFETCH.misses, PREFETCH.assembled))
        return real_measure()

    real_measure = pipe.measure_prosody_and_build_ssml
    pipe.measure_prosody_and_build_ssml = spy_measure
    pipe.run()
    counts = (PREFETCH.hits, PREFETCH.misses, PREFETCH.assembled)
    jpipe.run()
    PREFETCH.clear()
    return pipe, jpipe, counts, entries


def test_a_pipeline_run_takes_two_hits(runs):
    pipe, _, counts, entries = runs
    hits, misses, assembled = counts
    assert (hits, misses) == (2, 0)
    assert assembled == 1  # the raw corpus, from the segments Raw Synthesis wrote
    assert entries["counts"] == (0, 0, 1)
    assert len(entries["segments"]) == len(pipe._segment_files()) == 2


def test_the_resident_images_equal_the_host_loads(runs):
    """Each corpus entry's image is its host batch, bit for bit: the natural
    corpus as loaded, the raw one as assembled from its segments."""
    _, _, _, entries = runs
    assert len(entries["corpora"]) == 2
    for (batch, lens, rate, ok), res in entries["corpora"].values():
        assert res is not None and res.event is None
        assert res.tensor.dtype == torch.int16 and batch.dtype == np.int16
        np.testing.assert_array_equal(res.tensor.numpy(), batch)
        assert ok.all() and rate == 44100


def test_csvs_equal_an_empty_cache_run(runs, tmp_path):
    pipe, _, _, _ = runs
    PREFETCH.clear()
    segs = pipe._segment_files()
    res = measure_and_build_ssml(segs, pipe.textgrid_dir, pipe.raw_audio_dir, tmp_path, pipe.cfg.prosody,
                                 pipe.cfg.azure_voice_name, pipe.cfg.prosody.inter_syntagme_pause_factor, device="cpu")
    assert (PREFETCH.hits, PREFETCH.misses) == (0, 2)
    assert len(res.rows) > 2
    for name in CSV_NAMES:
        assert (tmp_path / name).read_bytes() == (pipe.results_dir / name).read_bytes(), name


@pytest.mark.parametrize("name", list(CSV_NAMES) + ["OUT.TextGrid", "pause_comparison_full.csv"])
def test_artifacts_equal_the_jax_pipeline(runs, name):
    pipe, jpipe, _, _ = runs
    assert (pipe.results_dir / name).read_bytes() == (jpipe.results_dir / name).read_bytes()


def test_the_multi_voice_runner_takes_four_hits(tmp_path):
    texts = {n: brute_voice(tmp_path, n, s) for n, s in (("va", 1), ("vb", 2))}
    cfg = PipelineConfig.from_dict(dict(config(texts), steps_to_run=["Preprocess"], multiprocessing=True), tmp_path)
    assert all(ok for ok, _ in batch_runner.run_all_voices(cfg, device="cpu"))
    for n, t in texts.items():
        write_transcripts(tmp_path / "Data" / "voice" / n, t)
    cfg.steps_to_run = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML"]
    PREFETCH.hits = PREFETCH.misses = 0
    assert all(ok for ok, _ in batch_runner.run_all_voices(cfg, device="cpu"))
    assert (PREFETCH.hits, PREFETCH.misses) == (4, 0)


@pytest.fixture()
def segments(tmp_path):
    seg_files, tg_dir, raw_dir = synth_voice(tmp_path / "v", seed=3, n_segments=3, seconds=(1.0, 2.0))
    return seg_files, tg_dir, raw_dir


def test_a_rewritten_segment_misses(segments):
    seg_files, _, _ = segments
    tm.prefetch_corpus(seg_files, device="cpu")
    assert tm._load_padded_cached(seg_files)[4] is not None and PREFETCH.hits == 1
    a = read_wav(seg_files[1])
    write_wav(seg_files[1], np.asarray(a.samples, np.float32)[: a.samples.shape[0] // 2], a.rate)
    batch, lens, _, _, res = tm._load_padded_cached(seg_files)
    assert res is None and PREFETCH.misses == 1
    assert lens[1] == a.samples.shape[0] // 2
    np.testing.assert_array_equal(batch, tm._load_padded(seg_files)[0])


def test_the_caps_evict_the_oldest(segments, tmp_path):
    seg_files, _, _ = segments
    keys = []
    for i in range(PREFETCH.CORPUS_CAP + 1):
        tm.prefetch_corpus(seg_files, rate_expect=8000 + i, device="cpu")
        keys.append(tm._corpus_key(seg_files, 8000 + i))
    assert len(PREFETCH.corpora) == PREFETCH.CORPUS_CAP
    assert keys[0] not in PREFETCH.corpora and all(k in PREFETCH.corpora for k in keys[1:])
    short = np.asarray(read_wav(seg_files[0]).samples, np.float32)[:2000]
    paths = []
    for i in range(PREFETCH.SEGMENT_CAP + 1):
        paths.append(tmp_path / f"s{i}.wav")
        write_wav(paths[-1], short, 44100)
        tm.prefetch_segment(paths[-1], device="cpu")
    assert len(PREFETCH.segments) == PREFETCH.SEGMENT_CAP
    assert tm._corpus_key([paths[0]], None) not in PREFETCH.segments
    assert all(tm._corpus_key([p], None) in PREFETCH.segments for p in paths[1:])


def test_the_data_mesh_takes_no_assembled_corpus(segments, monkeypatch):
    seg_files, tg_dir, raw_dir = segments
    raw = [raw_dir / f"{p.stem}.wav" for p in seg_files]
    monkeypatch.setenv("PCFT_DATA_MESH", "2")
    for p in raw:
        tm.prefetch_segment(p, rate_expect=44100, device="cpu")
    tm.prefetch_corpus(raw, rate_expect=44100, device="cpu")
    tm.prefetch_corpus(seg_files, device="cpu")
    assert PREFETCH.assembled == 0
    assert all(res is None for _, res in PREFETCH.corpora.values())
    got = tm.measure_voice(seg_files, tg_dir, raw_dir, ProsodySettings(), device="cpu")
    assert PREFETCH.hits == 2
    monkeypatch.delenv("PCFT_DATA_MESH")
    PREFETCH.clear()
    want = tm.measure_voice(seg_files, tg_dir, raw_dir, ProsodySettings(), device="cpu")
    assert [r.pitch_smooth for r in got.rows] == [r.pitch_smooth for r in want.rows]
    assert [r.raw_volume for r in got.rows] == [r.raw_volume for r in want.rows]


def test_a_resampled_corpus_is_not_assembled(segments, tmp_path):
    """Segments at 22.05 kHz for a 44.1 kHz corpus: the segment prefetch
    declines them (a resample is a float path), the corpus is uploaded from
    its float host load, and the measure step takes it."""
    seg_files, tg_dir, raw_dir = segments
    raw2 = tmp_path / "raw22"
    raw2.mkdir()
    for p in raw_dir.glob("*.wav"):
        write_wav(raw2 / p.name, resample(read_wav(p), 22050))
    raw = [raw2 / f"{p.stem}.wav" for p in seg_files]
    for p in raw:
        tm.prefetch_segment(p, rate_expect=44100, device="cpu")
    assert not PREFETCH.segments
    tm.prefetch_corpus(raw, rate_expect=44100, device="cpu")
    (batch, _, _, _), res = PREFETCH.corpora[tm._corpus_key(raw, 44100)]
    assert PREFETCH.assembled == 0 and batch.dtype == np.float32 and res is not None
    tm.prefetch_corpus(seg_files, device="cpu")
    prep = tm.prepare_voice(seg_files, tg_dir, raw2, ProsodySettings())
    assert PREFETCH.hits == 2 and prep.raw_dev is res
    # the int16 natural corpus is promoted to float32 beside it: its image no longer matches
    assert prep.nat.dtype == np.float32 and prep.nat_dev is None


def test_a_stale_image_is_uploaded_anew(segments):
    """The measure pass takes a prefetched image in place of the upload
    where its shape and dtype match the host array (an image marked here
    shows that it was taken), and passes over one whose shape or dtype no
    longer matches."""
    seg_files, tg_dir, raw_dir = segments
    tm.prefetch_corpus(seg_files, device="cpu")
    prep = tm.prepare_voice(seg_files, tg_dir, raw_dir, ProsodySettings())
    assert prep.nat_dev is not None and prep.nat_dev.tensor.shape == prep.nat.shape
    marked = torch.from_numpy(prep.nat.copy())
    marked[0, 0] += 1
    prep.nat_dev = tm.Resident(marked)
    g = tm._pack_group([(None, prep)], torch.device("cpu"))
    np.testing.assert_array_equal(g["nat"].numpy(), marked.numpy())
    for stale in (torch.zeros((1, 8), dtype=torch.int16), marked.to(torch.float32)):
        prep.nat_dev = tm.Resident(stale)
        g = tm._pack_group([(None, prep)], torch.device("cpu"))
        np.testing.assert_array_equal(g["nat"].numpy(), prep.nat)


def test_an_upload_error_propagates(segments, monkeypatch):
    seg_files, _, raw_dir = segments

    def broken(a, dev):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(PREFETCH, "upload", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tm.prefetch_corpus(seg_files, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        tm.prefetch_segment(raw_dir / f"{seg_files[0].stem}.wav", rate_expect=44100, device="cpu")
    assert not PREFETCH.corpora and not PREFETCH.segments


def test_what_jax_declines_is_declined(segments, tmp_path):
    """A missing file, a file that is not RIFF and a stereo file: no
    segment entry, no error."""
    seg_files, _, _ = segments
    (tmp_path / "bad.wav").write_bytes(b"OggS" + b"\0" * 100)
    a = read_wav(seg_files[0])
    write_wav(tmp_path / "stereo.wav", np.stack([a.samples, a.samples], -1).astype(np.float32), a.rate)
    for p in (tmp_path / "missing.wav", tmp_path / "bad.wav", tmp_path / "stereo.wav"):
        tm.prefetch_segment(p, device="cpu")
    assert not PREFETCH.segments
    tm.prefetch_corpus([], device="cpu")
    assert not PREFETCH.corpora


def test_prefetch_asks_for_the_card_by_default(segments):
    """Like every entry point, the hooks default to CUDA and raise without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    seg_files, _, _ = segments
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.prefetch_corpus(seg_files)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.prefetch_segment(seg_files[0])

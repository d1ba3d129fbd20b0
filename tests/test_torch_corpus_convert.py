"""The port's host-only corpus helpers (``audio/corpus.py``,
``audio/convert.py``) against the JAX package's: the same file trees, byte
for byte, and the same refusal without ffmpeg."""

import shutil

import numpy as np
import pytest

from prosody_control_french_tts_tpu.audio import convert as j_convert
from prosody_control_french_tts_tpu.audio import corpus as j_corpus
from prosody_control_french_tts_tpu.utils import wavio
from prosody_control_french_tts_tpu_torch.audio import convert as t_convert
from prosody_control_french_tts_tpu_torch.audio import corpus as t_corpus


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _wav(path, seed, seconds=0.3):
    x = (0.2 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    wavio.write_wav(path, x, 16000)


@pytest.fixture
def data_dir(tmp_path):
    d = tmp_path / "Data" / "voice"
    for v, voice in enumerate(("alice", "bob", "carol")):
        for i in range(1, 4):
            _wav(d / voice / "audio" / f"segment_ph{i}.wav", 10 * v + i)
            if not (voice == "bob" and i == 2):  # a segment without a transcript is left out
                (d / voice / "transcription").mkdir(parents=True, exist_ok=True)
                (d / voice / "transcription" / f"segment_ph{i}.txt").write_text(f"{voice} phrase {i}")
        _wav(d / f"{voice}_raw" / "audio" / "segment_ph1.wav", 100 + v)
        _wav(d / f"{voice}_raw" / "audio" / "segment_ph2.wav", 200 + v)
    (d / "dave").mkdir()  # no audio directory
    return d


def test_build_natural_corpus_matches_jax(data_dir, tmp_path):
    n_t = t_corpus.build_natural_corpus(data_dir, tmp_path / "port")
    n_j = j_corpus.build_natural_corpus(data_dir, tmp_path / "jax")
    assert n_t == n_j == 8
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_stage_abtest_files_matches_jax(data_dir, tmp_path):
    results = tmp_path / "Out" / "results"
    for v, voice in enumerate(("alice", "carol", "erin")):
        _wav(results / voice / "OUT.wav", 300 + v)
    (results / "bob").mkdir(parents=True)  # no OUT.wav
    n_t = t_corpus.stage_abtest_files(results, data_dir, tmp_path / "port")
    n_j = j_corpus.stage_abtest_files(results, data_dir, tmp_path / "jax")
    assert n_t == n_j == 2
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_convert_copies_wavs_and_refuses_without_ffmpeg(tmp_path, monkeypatch):
    _wav(tmp_path / "in" / "a.wav", 1)
    (tmp_path / "in" / "b.mp3").write_bytes(b"ID3 not really an mp3")
    (tmp_path / "in" / "notes.txt").write_text("skip me")
    assert t_convert.convert_to_wav(tmp_path / "in" / "a.wav", tmp_path / "out" / "a.wav") == tmp_path / "out" / "a.wav"
    assert (tmp_path / "out" / "a.wav").read_bytes() == (tmp_path / "in" / "a.wav").read_bytes()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not t_convert.ffmpeg_available() and not j_convert.ffmpeg_available()
    with pytest.raises(RuntimeError) as t_err:
        t_convert.convert_folder(tmp_path / "in", tmp_path / "port")
    with pytest.raises(RuntimeError) as j_err:
        j_convert.convert_folder(tmp_path / "in", tmp_path / "jax")
    assert str(t_err.value) == str(j_err.value)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")

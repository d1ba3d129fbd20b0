"""The port's native audio ingest against the JAX package's.

The port builds its own copy of the C++ ingest (``utils/native_audio.py``,
``prosody_control_french_tts_tpu_torch/native/audioio.cpp``); the JAX
package loads its own library. On the same files, made here from a numpy
seed:

- every entry point agrees byte for byte: ``decode`` over the RIFF formats
  the parser takes, ``load_batch`` from 16/24/44.1/48 kHz into 44.1 and 48
  kHz, ``load_batch_i16``, ``window_rms`` and the bytes ``write_wav_f32``
  writes;
- ``prosody.measure._load_padded`` is bit-equal to the JAX package's on a
  44.1 kHz file beside a 24 kHz noise file (``rate_expect=44100``), on a 3 s
  44.1 kHz voiced tone taken to 48 kHz, and on corpora with a missing file
  (a path: the native loader; None: the Python path of both). Before the
  port read corpora through its own ingest, it resampled them with scipy's
  polyphase filter, which reads the first two corpora up to 0.149 and
  1.5e-3 away from the windowed sinc (a test keeps that gap in view);
- ``measure_voice`` on a 48 kHz voice whose raw corpus is 44.1 kHz agrees
  with JAX's within the golden tolerances (F0 medians 1e-3 relative, LUFS
  0.01 dB);
- a failed build raises, and so does the corpus load that needs it.
"""

import struct

import numpy as np
import pytest

from prosody_control_french_tts_tpu.prosody import adjust as ja, measure as jm
from prosody_control_french_tts_tpu.utils import native_audio as jn, wavio as jw
from prosody_control_french_tts_tpu_torch.prosody import adjust as ta, measure as tm
from prosody_control_french_tts_tpu_torch.utils import native_audio as tn, wavio as tw
from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

RATES = (16000, 24000, 44100, 48000)


def test_the_jax_side_takes_its_native_path():
    assert jn.available()


def riff(path, data: bytes, tag: int, channels: int, rate: int, bits: int, extensible: bool = False):
    """A RIFF/WAVE file with one fmt and one data chunk, and a LIST chunk of
    odd size between them that the chunk walk must skip."""
    block = channels * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels, rate, rate * block, block, bits)
    fmt = head + (struct.pack("<HHIH", 22, bits, 0, tag) + b"\0" * 14 if extensible else b"")
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"LIST" + struct.pack("<I", 3) + b"abc\0"
    body += b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


@pytest.fixture(scope="module")
def formats(tmp_path_factory):
    """One file per format the parser takes, a file that is not RIFF and a
    path with no file."""
    d = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(0)
    t = np.arange(3001) / 8000.0
    x = np.clip(0.4 * np.sin(2 * np.pi * 230.0 * t)[:, None] + 0.1 * rng.standard_normal((3001, 2)), -0.99, 0.99)
    i16 = np.round(x * 32767).astype("<i2")
    i32 = np.round(x * 2147483000).astype("<i4")
    i24 = np.round(x * 8388000).astype(np.int64) & 0xFFFFFF
    b24 = np.stack([i24 & 0xFF, (i24 >> 8) & 0xFF, i24 >> 16], -1).astype(np.uint8).tobytes()
    u8 = np.round(x * 127 + 128).astype(np.uint8)
    (d / "h.wav").write_bytes(b"OggS" + b"\0" * 60)
    return {
        "pcm16_mono": riff(d / "a.wav", i16[:, 0].tobytes(), 1, 1, 22050, 16),
        "pcm16_stereo": riff(d / "b.wav", i16.tobytes(), 1, 2, 44100, 16),
        "pcm8_stereo": riff(d / "c.wav", u8.tobytes(), 1, 2, 16000, 8),
        "pcm24_stereo": riff(d / "d.wav", b24, 1, 2, 48000, 24),
        "pcm32_mono": riff(d / "e.wav", i32[:, 0].tobytes(), 1, 1, 24000, 32),
        "float32_stereo": riff(d / "f.wav", x.astype("<f4").tobytes(), 3, 2, 44100, 32),
        "extensible_pcm16": riff(d / "g.wav", i16.tobytes(), 1, 2, 32000, 16, extensible=True),
        "not_riff": d / "h.wav",
        "missing": d / "missing.wav",
    }


@pytest.fixture(scope="module")
def rates_corpus(tmp_path_factory):
    """Mono PCM16 files of 0.3–1.2 s at each of RATES, written by numpy."""
    d = tmp_path_factory.mktemp("rates")
    rng = np.random.default_rng(1)
    paths = []
    for i, r in enumerate(RATES):
        n = int(r * rng.uniform(0.3, 1.2))
        t = np.arange(n) / r
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 260) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        x = (x + 0.05 * rng.standard_normal(n)).astype(np.float64)  # float64: the numpy writer
        jw.write_wav(d / f"r{i}.wav", x, r)
        paths.append(d / f"r{i}.wav")
    return paths


@pytest.mark.parametrize("name", ["pcm16_mono", "pcm16_stereo", "pcm8_stereo", "pcm24_stereo", "pcm32_mono",
                                  "float32_stereo", "extensible_pcm16", "not_riff", "missing"])
def test_decode_matches_jax(formats, name):
    got, want = tn.decode(formats[name]), jn.decode(formats[name])
    if want is None:
        assert got is None
        return
    assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.float32
    assert got[0].tobytes() == want[0].tobytes()
    assert got[0].size == 3001


@pytest.mark.parametrize("target", [44100, 48000, 0])
def test_load_batch_matches_jax(rates_corpus, formats, target):
    """16/24/44.1/48 kHz resampled into the target (0: kept), beside a
    stereo float file, an unreadable file and a missing one."""
    paths = rates_corpus + [formats["float32_stereo"], formats["not_riff"], formats["missing"]]
    stride = 70000
    got, want = tn.load_batch(paths, stride, target), jn.load_batch(paths, stride, target)
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype == np.int32
    assert got[2] == want[2] == (target or 16000)
    assert (got[1][-2:] == 0).all() and (got[1][:-2] > 0).all()


def test_load_batch_i16_matches_jax(rates_corpus, formats):
    same_rate = [rates_corpus[2], formats["missing"], rates_corpus[2]]
    for paths, target in ((same_rate, 44100), (same_rate, 0), (rates_corpus, 44100), (same_rate, 48000),
                          ([formats["pcm16_stereo"]], 44100), ([formats["float32_stereo"]], 44100)):
        got, want = tn.load_batch_i16(paths, 60000, target), jn.load_batch_i16(paths, 60000, target)
        if want is None:
            assert got is None, (paths, target)
            continue
        assert got[0].dtype == np.int16 and got[0].tobytes() == want[0].tobytes()
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == 44100


@pytest.mark.parametrize("rate,window_ms", [(44100, 1000), (16000, 250), (48000, 10)])
def test_window_rms_matches_jax(rate, window_ms):
    rng = np.random.default_rng(rate)
    x = (0.2 * rng.standard_normal(int(2.7 * rate)) * (rng.random(int(2.7 * rate)) < 0.5)).astype(np.float32)
    got, want = tn.window_rms(x, rate, window_ms), jn.window_rms(x, rate, window_ms)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_f32_bytes_match_jax(tmp_path, channels):
    """The bytes written, clipping, infinities and NaN included, and the
    port's ``write_wav`` (which takes this path for float32) equal to JAX's
    and to the numpy quantization of float64 input."""
    rng = np.random.default_rng(channels)
    x = (1.3 * rng.standard_normal((7001, channels))).astype(np.float32)
    x[3, 0], x[4, -1], x[5, 0] = np.nan, np.inf, -np.inf
    x[6, 0] = 0.5 / 32768  # a tie: rounds half to even
    x = x[:, 0] if channels == 1 else x
    assert tn.write_wav_f32(tmp_path / "t.wav", x, 24000, channels)
    assert jn.write_wav_f32(tmp_path / "j.wav", x, 24000, channels)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    tw.write_wav(tmp_path / "tw.wav", x, 24000)
    jw.write_wav(tmp_path / "jw.wav", x, 24000)
    assert (tmp_path / "tw.wav").read_bytes() == (tmp_path / "jw.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    finite = np.nan_to_num(x, nan=0.0)
    tw.write_wav(tmp_path / "f64.wav", finite.astype(np.float64), 24000)
    assert (tmp_path / "f64.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()


def test_write_wav_raises_where_it_cannot_write(tmp_path):
    with pytest.raises(FileNotFoundError):
        tw.write_wav(tmp_path / "no_such_dir" / "x.wav", np.zeros(10, np.float32), 16000)


# ---------------------------------------------------------------------------
# _load_padded against the JAX package's
# ---------------------------------------------------------------------------


def voiced(rate: int, seconds: float, seed: int) -> np.ndarray:
    """A voiced tone with a vibrato and harmonics, PCM16-exact."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    f0 = 150 + 30 * np.sin(2 * np.pi * 0.7 * t)
    ph = 2 * np.pi * np.cumsum(f0) / rate
    x = sum(a * np.sin(k * ph) for k, a in ((1, 0.4), (2, 0.2), (3, 0.1), (5, 0.05)))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2.3 * t)) + 0.003 * rng.standard_normal(t.size)
    return np.round(x * 32768) / 32768


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(2)
    jw.write_wav(d / "a44.wav", voiced(44100, 1.5, 3), 44100)
    jw.write_wav(d / "n24.wav", np.clip(0.3 * rng.standard_normal(24000), -1, 1), 24000)
    jw.write_wav(d / "tone44.wav", voiced(44100, 3.0, 4), 44100)
    return d


CORPORA = {
    "44.1+24kHz_to_44.1kHz": (["a44.wav", "n24.wav"], 44100),
    "44.1kHz_tone_to_48kHz": (["tone44.wav"], 48000),
    "missing_path": (["a44.wav", "gone.wav", "n24.wav"], 44100),
    "missing_none": (["a44.wav", None, "n24.wav"], 44100),
    "missing_none_unset_rate": ([None, "tone44.wav"], None),
}


@pytest.mark.parametrize("case", list(CORPORA))
def test_load_padded_bit_equal_to_jax(mixed, case):
    names, rate = CORPORA[case]
    paths = [None if n is None else mixed / n for n in names]
    got = tm._load_padded(paths, rate_expect=rate)
    want = jm._load_padded(paths, rate_expect=rate)
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype == np.int32
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("case,gap", [("44.1+24kHz_to_44.1kHz", 0.01), ("44.1kHz_tone_to_48kHz", 1e-3)])
def test_the_sinc_and_scipy_resamplers_differ(mixed, case, gap):
    """The fault the native ingest repairs: scipy's polyphase resampler
    (the Python path) reads these corpora otherwise than the windowed sinc,
    by more than ``gap`` (0.149 and 1.5e-3 measured)."""
    names, rate = CORPORA[case]
    paths = [mixed / n for n in names]
    native = tm._load_padded(paths, rate_expect=rate)
    scipy_path = tm._load_padded(paths + [None], rate_expect=rate)  # a None item takes the Python path
    a = np.asarray(native[0], np.float32)
    b = np.asarray(scipy_path[0], np.float32)[: len(paths), : a.shape[1]]
    assert np.abs(a - b).max() > gap


@pytest.fixture(scope="module")
def voice48(tmp_path_factory):
    """A 48 kHz voice (3 segments of 1–2 s) whose raw corpus is its raw
    rendering taken to 44.1 kHz."""
    root = tmp_path_factory.mktemp("voice48")
    seg_files, tg_dir, raw_dir = synth_voice(root, seed=5, n_segments=3, seconds=(1.0, 2.0), rate=48000)
    for p in sorted(raw_dir.glob("*.wav")):
        jw.write_wav(p, jw.resample(jw.read_wav(p), 44100))
    return seg_files, tg_dir, raw_dir


def test_measure_voice_with_a_resampled_raw_corpus_matches_jax(voice48):
    seg_files, tg_dir, raw_dir = voice48
    assert jw.wav_info(raw_dir / f"{seg_files[0].stem}.wav")[1] == 44100
    prep = tm.prepare_voice(seg_files, tg_dir, raw_dir, ta.ProsodySettings())
    assert prep.rate == 48000 and prep.raw_for_device.dtype == np.float32
    res_j = jm.measure_voice(seg_files, tg_dir, raw_dir, ja.ProsodySettings())
    res_t = tm.measure_voice(seg_files, tg_dir, raw_dir, ta.ProsodySettings(), device="cpu")
    assert len(res_t.rows) == len(res_j.rows) > 3
    for st, sj in zip(res_t.seg_stats, res_j.seg_stats):
        assert abs(st.p_nat - sj.p_nat) <= 1e-3 * sj.p_nat
        assert abs(st.l_nat - sj.l_nat) <= 0.01 and abs(st.l_syn - sj.l_syn) <= 0.01
        assert (st.d_nat, st.d_syn, st.wc) == (sj.d_nat, sj.d_syn, sj.wc)
    for rt, rj in zip(res_t.rows, res_j.rows):
        assert (rt.segment, rt.syntagme, rt.pause) == (rj.segment, rj.syntagme, rj.pause)
        assert abs(rt.raw_rate - rj.raw_rate) <= 1e-5
        assert abs(rt.raw_volume - rj.raw_volume) <= 0.05
        assert abs(rt.pitch_smooth - rj.pitch_smooth) <= 0.05


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch, mixed):
    """A source g++ refuses: the build raises, and so does the corpus load
    (no Python path is taken in its place)."""
    bad = tmp_path / "audioio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tn.library()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tm._load_padded([mixed / "a44.wav"], rate_expect=44100)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tw.write_wav(tmp_path / "x.wav", np.zeros(4, np.float32), 16000)


def test_the_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    """An edited source builds a library of another name; an unchanged one
    is not rebuilt."""
    src = tmp_path / "audioio.cpp"
    src.write_bytes(tn.SOURCE.read_bytes())
    monkeypatch.setattr(tn, "SOURCE", src)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    first = tn.build()
    mtime = first.stat().st_mtime_ns
    assert tn.build() == first and first.stat().st_mtime_ns == mtime
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    second = tn.build()
    assert second != first and second.exists()

"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, names neither in its sources, and its entry points run on CUDA by
default — raising, not falling back, on a host without a card."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "prosody_control_french_tts_tpu_torch"


def _modules():
    return sorted(
        "prosody_control_french_tts_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name != "__init__.py"
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert len(mods) >= 25
    for name in ("ops.vmem_attn", "ops.fused_ce", "models.training", "ops.frames", "ops.chunk_cumsum", "ops.energy",
                 "core.pipeline", "core.config", "align.energy", "tts.fake", "ssml.parse", "eval.breaks",
                 "ops.stft", "ops.mask_ema", "audio.denoise", "audio.separate", "audio.merge", "core.batch_runner",
                 "core.synchronized", "tts.batch", "align.whisper", "align.ctc", "align.ctc_aligner", "ops.dtw",
                 "ops.ctc_viterbi", "align.lexicon_decode", "align.synth_speech", "models.bpe_tokenizer",
                 "models.bert", "models.bilstm", "models.datasets", "models.break_trainer", "models.bilstm_runner",
                 "models.fewshot", "models.experiment", "models.report_html", "serving.batcher", "serving.predictor",
                 "models.pos_data", "models.pos_tagger", "eval.yin", "eval.metrics", "eval.evaluate_voice",
                 "eval.corpus_compare", "eval.dataset_stats", "eval.abtest", "eval.aligner_harness",
                 "eval.real_audio_agreement", "align.needleman_wunsch", "align.levenshtein_merge", "ops.ctc_loss",
                 "align.train_ctc", "align.pretrain_ctc", "align.pretrain_whisper", "audio.corpus", "audio.convert",
                 "models.schedules", "core.checkpoint", "models.port_weights", "legacy.bdd", "legacy.needleman",
                 "legacy.voc", "viz.plotdata", "viz.acoustic", "viz.server", "__main__", "parallel.mesh",
                 "parallel.sharding", "parallel.distributed", "parallel.measure_sharded",
                 "utils.native_audio", "tts.azure"):
        assert f"prosody_control_french_tts_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'transformers' "
        "or m == 'prosody_control_french_tts_tpu' or m.startswith('prosody_control_french_tts_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(r"\bjax\b|prosody_control_french_tts_tpu(?!_torch)")
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")]
    assert any(p.suffix == ".cu" for p in files) and any(p.suffix == ".cpp" for p in files)
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files for i, line in enumerate(p.read_text().splitlines(), 1) if pat.search(line)]
    assert not hits, hits


def test_no_port_file_refers_to_the_jax_native_library():
    """The port builds its own ingest from its own source: no file of the
    port names the JAX side's ``native/`` directory or its ``libaudioio``,
    the build reads and writes nothing there, and a process that reads a
    corpus through the port maps no library from it."""
    pat = re.compile(r"libaudioio|parent\.parent\.parent\s*/\s*[\"']native|[\"']\.\./native|(^|[\s\"'`(])native/(Makefile|audioio)")
    files = [p for p in PKG.rglob("*") if p.is_file() and p.suffix not in (".pyc", ".npz", ".so", ".png", ".ico")]
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text(errors="replace").splitlines(), 1) if pat.search(line)]
    assert not hits, hits
    from prosody_control_french_tts_tpu_torch.utils import native_audio

    jax_native = (ROOT / "native").resolve()
    assert native_audio.SOURCE.resolve().is_relative_to(PKG)
    assert not native_audio.BUILD_DIR.resolve().is_relative_to(jax_native)
    code = (
        "import sys, numpy as np\n"
        "from prosody_control_french_tts_tpu_torch.prosody.measure import _load_padded\n"
        "from prosody_control_french_tts_tpu_torch.utils import native_audio, wavio\n"
        "wavio.write_wav(sys.argv[1], np.zeros(4410, np.float32), 44100)\n"
        "assert _load_padded([sys.argv[1]])[1].tolist() == [4410]\n"
        "maps = open('/proc/self/maps').read()\n"
        f"assert {str(jax_native)!r} not in maps and 'libaudioio' not in maps, maps\n"
        "assert str(native_audio.build()) in maps\n"
        "print('ok')\n"
    )
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sys.executable, "-c", code, str(Path(tmp) / "x.wav")], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_chip_smoke_imports_neither():
    """chip_smoke.py names the TPU kernels it replaces, but imports nothing
    of JAX or the JAX package."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|prosody_control_french_tts_tpu)\b(?!_torch)", text, re.M)
    assert "prosody_control_french_tts_tpu_torch" in text


def test_default_device_raises_without_cuda(tmp_path):
    """Every entry point defaults to CUDA; on a host without a card the call
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.core.pipeline import measure_and_build_ssml
    from prosody_control_french_tts_tpu_torch.ops.loudness import integrated_loudness
    from prosody_control_french_tts_tpu_torch.ops.pitch import praat_pitch
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import measure_voice

    x = np.zeros(44100, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        praat_pitch(x, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        integrated_loudness(x, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_voice([], tmp_path, tmp_path, ProsodySettings())
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_and_build_ssml([], tmp_path, tmp_path, tmp_path, ProsodySettings(), "v", 1.0)


def test_pipeline_entry_points_default_to_cuda(tmp_path):
    """The voice pipeline, the silence scan and the energy aligner default to
    CUDA and raise without a card; the frame and cumsum wrappers run their
    plain versions on CPU tensors only because they lie on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.align.energy import EnergyAligner
    from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig
    from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
    from prosody_control_french_tts_tpu_torch.ops import chunk_cumsum, frames
    from prosody_control_french_tts_tpu_torch.ops.energy import detect_nonsilent, detect_silence, split_on_silence_ranges
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio

    x = np.zeros(3 * 44100, np.float32)
    cfg = PipelineConfig.from_dict({"tts_backend": "fake"}, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioPipeline("v", cfg)
    assert not (tmp_path / "Out").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        split_on_silence_ranges(x, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_silence(x, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_nonsilent(x, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        EnergyAligner().align(Audio(x, 44100), "bonjour")
    assert AudioPipeline("v", cfg, device="cpu").device.type == "cpu"
    w = torch.ones(8)
    assert frames.frames_op(torch.zeros(64), torch.zeros(2, dtype=torch.int32), w).device.type == "cpu"
    assert chunk_cumsum.chunk_cumsum(torch.zeros((8, 1024))).device.type == "cpu"


def test_llm_entry_points_default_to_cuda():
    """The LLM slice: building a model, the caches, both greedy decoders, the
    cascade and the perplexity all default to CUDA and raise without a card;
    the kernel wrapper runs its plain version on CPU tensors only because
    they lie on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.models import cascade, llm, llm_eval
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer
    from prosody_control_french_tts_tpu_torch.ops.decode_attn import decode_attention

    cfg = llm.LLMConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        llm.DecoderLM(cfg)
    model = llm.DecoderLM(cfg, device="cpu")
    fp = llm.fuse_decode_params(model, cfg)
    ids = np.ones((1, 4), np.int32)
    tok = WordPieceTokenizer.train(["le chat dort", "le chien dort"], vocab_size=60, min_freq=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        llm.greedy_generate(model, ids, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        llm.greedy_generate_fused(fp, cfg, ids, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        llm.init_kv_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        llm.init_kv_caches_fused(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cascade.generate(model, tok, cascade.TASK_A, "le chat", max_new=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cascade.run_cascade(model, model, tok, "le chat")
    with pytest.raises(RuntimeError, match="CUDA"):
        llm_eval.teacher_forced_perplexity(model, ids[0], ids[0])
    q = torch.zeros((1, 4, 64))
    c = torch.zeros((1, 8, 128))
    assert decode_attention(q, c, c, 0, 2).device.type == "cpu"


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; a tensor
    elsewhere goes to the kernel or raises."""
    from prosody_control_french_tts_tpu_torch.ops import candidates, decode_attn, fused_ce, viterbi, vmem_attn

    q4 = torch.empty((1, 128, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vmem_attn.causal_attention_vmem(q4, q4[:, :, :2], q4[:, :, :2], 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce.linear_ce_rows(torch.empty((8, 128), device="meta"), torch.empty((128, 512), device="meta"), torch.empty((8,), dtype=torch.int32, device="meta"))
    meta = torch.empty((4, 297), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        candidates.topk_parabolic(meta, 14, 72, 295, 0.45)
    m3 = torch.empty((1, 4, 15), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        viterbi.viterbi_path(m3, m3, m3.bool(), m3, 0.1, 0.2)
    q = torch.empty((2, 14, 64), device="meta")
    kv = torch.empty((2, 16, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attn.decode_attention(q, kv, kv, 3, 2)
    import numpy as np

    from prosody_control_french_tts_tpu_torch.ops import chunk_cumsum, frames

    with pytest.raises(ValueError, match="unsupported device"):
        frames.frames_op(torch.empty(64, device="meta"), torch.empty(2, dtype=torch.int32, device="meta"), torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        chunk_cumsum.chunk_cumsum(torch.empty((8, 1024), device="meta"))
    from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig
    from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline
    from prosody_control_french_tts_tpu_torch.ops.energy import split_on_silence_ranges

    with pytest.raises(ValueError, match="unsupported device"):
        split_on_silence_ranges(np.zeros(44100, np.float32), 44100, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        AudioPipeline("v", PipelineConfig.from_dict({"tts_backend": "fake"}, "."), device="meta")


def test_acoustic_aligners_default_to_cuda():
    """The acoustic aligners, built by name or directly, default to CUDA and
    raise without a card; asked for the CPU, they run there, and the CTC
    Viterbi wrapper takes its plain version for CPU tensors only."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    from prosody_control_french_tts_tpu_torch.align.base import get_aligner
    from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner
    from prosody_control_french_tts_tpu_torch.align.whisper import WhisperAligner
    from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi

    for name in ("whisper", "whisper_jax", "ctc"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_aligner(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        WhisperAligner()
    with pytest.raises(RuntimeError, match="CUDA"):
        CTCAligner()
    assert get_aligner("ctc", device="cpu").device.type == "cpu"
    assert get_aligner("whisper", device="cpu").device.type == "cpu"
    states, _ = ctc_viterbi.ctc_forced_align(torch.zeros((3, 4)), torch.tensor([1]), 3, 1)
    assert states.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_viterbi.ctc_forced_align(torch.zeros((3, 4), device="meta"), torch.tensor([1]), 3, 1)


def test_training_entry_points_default_to_cuda(tmp_path):
    """The aligners' and the separator's training recipes default to CUDA and
    raise without a card before any work; the CTC loss takes its plain
    version for CPU tensors only."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    from prosody_control_french_tts_tpu_torch.align import pretrain_ctc, pretrain_whisper
    from prosody_control_french_tts_tpu_torch.align.train_ctc import train_ctc_aligner
    from prosody_control_french_tts_tpu_torch.audio.separate import pretrain_masknet
    from prosody_control_french_tts_tpu_torch.ops import ctc_loss

    for call in (lambda: train_ctc_aligner(tmp_path, tmp_path / "w.npz"),
                 lambda: pretrain_ctc.pretrain(tmp_path / "c.npz"),
                 lambda: pretrain_whisper.pretrain(tmp_path / "w"),
                 lambda: pretrain_masknet(tmp_path / "m.npz")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not any(tmp_path.iterdir())
    loss = ctc_loss.ctc_loss(torch.zeros((3, 4)), torch.tensor([1]), 3, 1)
    assert loss.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_loss.ctc_loss(torch.zeros((3, 4), device="meta"), torch.tensor([1]), 3, 1)


def test_break_predictor_entry_points_default_to_cuda():
    """The break-predictor slice: the models, the predictor, the trainers, the
    throughput metric, the sentence embedder and the few-shot LLM client
    default to CUDA and raise without a card; asked for the CPU, they run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.models import bert, bilstm, break_trainer, bilstm_runner, fewshot, llm
    from prosody_control_french_tts_tpu_torch.models.datasets import BreakTagDataset
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer
    from prosody_control_french_tts_tpu_torch.serving.predictor import SSMLPredictor

    tok = WordPieceTokenizer.train(["le chat dort", "le chien dort"], vocab_size=60, min_freq=1)
    cfg = bert.BertConfig(vocab_size=len(tok), hidden=16, layers=1, heads=2, ffn=32, max_len=8)
    ids = np.full((2, 8), tok.pad_id, np.int32)
    ids[:, :3] = tok.encode("le chat dort")[:3]
    ds = BreakTagDataset(ids, ids != tok.pad_id, np.zeros((2, 8), np.int32))
    for cls in (bert.BreakTagger, bert.SentenceEncoder):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bilstm.BiLSTMProsody(bilstm.BiLSTMConfig(embed_dim=16))
    tagger = bert.BreakTagger(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SSMLPredictor(tok, cfg, tagger.state_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        break_trainer.train_tagger(ds, cfg, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        break_trainer.sentences_per_second(tagger, None, ds, batch_size=2, iters=1)
    xs, ys = np.zeros((4, 2, 16), np.float32), np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bilstm.train_bilstm(xs, ys, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bilstm_runner.embed_sentences(["le chat dort"], tok, cfg)
    model = llm.DecoderLM(llm.LLMConfig.tiny(len(tok)), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fewshot.LocalLLMClient(model, tok)
    predictor = SSMLPredictor(tok, cfg, tagger.state_dict(), device="cpu")
    try:
        assert predictor.predict("le chat dort")["words"] == ["le", "chat", "dort"]
    finally:
        assert predictor.close()
    assert break_trainer.train_tagger(ds, cfg, epochs=1, device="cpu")[1].keys() == tagger.state_dict().keys()
    assert break_trainer.sentences_per_second(tagger, None, ds, batch_size=2, iters=1, device="cpu") > 0
    assert len(bilstm.train_bilstm(xs, ys, epochs=1, device="cpu")[1]) == 1
    assert bilstm_runner.embed_sentences(["le chat dort"], tok, cfg, device="cpu").shape == (1, 16)
    assert isinstance(fewshot.LocalLLMClient(model, tok, max_new=2, device="cpu").complete("le chat"), str)


def test_pos_tagger_and_eval_entry_points_default_to_cuda(tmp_path):
    """The contextual POS tagger and the evaluation layer: the tagger, its
    backend, its trainer, the cross-aligner agreement and the corpus
    features default to CUDA and raise without a card; asked for the CPU,
    they run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.eval import corpus_compare, metrics, real_audio_agreement
    from prosody_control_french_tts_tpu_torch.models import pos_tagger
    from prosody_control_french_tts_tpu_torch.models.pos_data import generate_treebank
    from prosody_control_french_tts_tpu_torch.utils.wavio import Audio, write_wav

    sents = generate_treebank(8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pos_tagger.ContextualTagger()
    with pytest.raises(RuntimeError, match="CUDA"):
        pos_tagger.get_pos_backend("contextual")
    with pytest.raises(RuntimeError, match="CUDA"):
        pos_tagger.train_pos_tagger(sents, steps=1, batch_size=2)
    clip = Audio(np.zeros(16000, np.float32), 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        real_audio_agreement.segment_agreement(clip, "s")
    write_wav(tmp_path / "a.wav", clip)
    with pytest.raises(RuntimeError, match="CUDA"):
        corpus_compare.extract_features(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.f0_contour(clip.samples, 16000, method="boersma")
    assert pos_tagger.get_pos_backend("lexicon").pos_of_factory is None
    assert len(pos_tagger.ContextualTagger(device="cpu").tag_tokens(["le", "son"])) == 2
    assert pos_tagger.get_pos_backend("contextual", device="cpu").pos_of_factory is not None
    state, _, _ = pos_tagger.train_pos_tagger(sents, steps=1, batch_size=2, log_every=0, device="cpu")
    assert all(v.device.type == "cpu" for v in state.values())
    assert corpus_compare.extract_features(tmp_path, device="cpu")["pitch_mean"].shape == (1,)


def test_packaged_pos_checkpoint_is_the_jax_packages():
    """The port reads its own copy of the tagger's checkpoint, byte for byte
    the JAX package's."""
    mine = PKG / "models" / "pretrained" / "pos_fr.npz"
    theirs = ROOT / "prosody_control_french_tts_tpu" / "models" / "pretrained" / "pos_fr.npz"
    assert mine.read_bytes() == theirs.read_bytes()


def test_front_ends_default_to_cuda(tmp_path):
    """The host front ends of the umbrella command line: the legacy chain,
    its pitch stage, the plot data and the viewer default to CUDA and raise
    without a card; asked for the CPU, they run. The converters and the
    checkpoints follow their inputs' devices."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    import numpy as np

    from prosody_control_french_tts_tpu_torch.legacy import bdd
    from prosody_control_french_tts_tpu_torch.legacy.voc import Voc
    from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend
    from prosody_control_french_tts_tpu_torch.utils.wavio import write_wav
    from prosody_control_french_tts_tpu_torch.viz.plotdata import compute_plot_data
    from prosody_control_french_tts_tpu_torch.viz.server import VizService

    t = np.arange(44100) / 44100
    write_wav(tmp_path / "segment_ph1.wav", (0.4 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        Voc(tmp_path, tmp_path, tmp_path / "out", tts=FakeBackend())
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        bdd.compute_pitch_adjustments([])
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_plot_data(tmp_path / "segment_ph1.wav")
    with pytest.raises(RuntimeError, match="CUDA"):
        VizService({"natural": tmp_path})
    assert compute_plot_data(tmp_path / "segment_ph1.wav", device="cpu")["sample_rate"] == 44100
    assert VizService({"natural": tmp_path}, device="cpu").plot_data("natural", "segment_ph1")["duration"] == 1.0
    assert Voc(tmp_path, tmp_path, tmp_path / "out", tts=FakeBackend(), device="cpu").device.type == "cpu"

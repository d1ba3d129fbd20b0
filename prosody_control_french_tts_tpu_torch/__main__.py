"""Umbrella CLI: ``python -m prosody_control_french_tts_tpu_torch <command>``.

Commands mirror the reference's entry points (README.md:118-143 usage):

  run               the 8-step voice pipeline (Code/audioPipeline.py __main__)
  sync              the synchronized-SSML 6-step pipeline
  legacy            the BDD1→BDD5 Voc chain
  abtest            AB-test pair preparation (Code/prepare_AB_test.py)
  viz               plot-data HTTP viewer (visualisation apps)
  analyze           corpus statistics (analyze_dataset.py)
  corpus            natural-corpus assembly (create_natural_data.py)
  eval              the paper's metrics over every voice of a config
  train-break       BERT break-tagger experiment on a bdd.json
  train-bilstm      BiLSTM prosody-head sequence-length sweep
  fewshot           few-shot LLM experiment (stub or Ollama clients)
  cascade           the two-stage LoRA cascade experiment
  train-ctc         bootstrap the CTC forced aligner from wav+txt pairs
  pretrain-ctc      rebuild the packaged out-of-the-box CTC checkpoint
  pretrain-whisper  rebuild the packaged out-of-the-box Whisper checkpoint
  pretrain-masknet  rebuild the packaged vocal-isolation checkpoint
  pretrain-pos      rebuild the packaged contextual French POS tagger
  agreement         label-free cross-aligner agreement report on a corpus
  bench             not ported: prints why and returns 1

Every command that computes on the device takes ``--device`` (default
``cuda``; without a card it raises unless given ``--device cpu``): run,
legacy, viz, eval, train-break, train-bilstm, cascade, train-ctc, the four
pretrain commands and agreement. sync, abtest, analyze, corpus and fewshot
run on the host. The pretrain commands write the packaged checkpoints
unless given ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _parser(prog: str, device: bool = True) -> argparse.ArgumentParser:
    """A command's parser; with ``device``, its ``--device`` is resolved
    while the arguments are parsed, so a card asked for and missing raises
    before any work."""
    ap = argparse.ArgumentParser(prog=prog)
    if device:
        from .ops.kernels import resolve_device

        ap.add_argument("--device", default="cuda", type=resolve_device)
    return ap


def _voice_pipeline(rest: list[str], prog: str, device: bool = True):
    """(args, cfg, AudioPipeline) of a command that works in a voice's
    pipeline directories; without ``device`` the command runs on the host
    and its pipeline is built on the CPU."""
    from .core.config import load_config
    from .core.pipeline import AudioPipeline

    ap = _parser(prog, device=device)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--voice", required=True)
    args = ap.parse_args(rest)
    cfg = load_config(args.config)
    return args, cfg, AudioPipeline(args.voice, cfg, device=args.device if device else "cpu")


def main(argv: list[str] | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    # long-running commands (pretrain-*, agreement) narrate via log.info;
    # surface it like the reference's Tee-style step logging
    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s", force=False)
    if cmd == "run":
        from .core.pipeline import main as run_main

        return run_main(rest)
    if cmd == "sync":
        from .core.synchronized import SynchronizedSSMLPipeline

        _, cfg, pipe = _voice_pipeline(rest, "sync", device=False)
        sp = SynchronizedSSMLPipeline(
            audio_dir=pipe.voice_dir / "audio",
            textgrid_dir=pipe.textgrid_dir,
            transcription_dir=pipe.transcription_dir,
            work_dir=pipe.results_dir / "synchronized",
            tts=pipe.tts,
            voice=cfg.azure_voice_name,
        )
        print(sp.run_pipeline())
        return 0
    if cmd == "legacy":
        from .legacy.voc import Voc

        args, cfg, pipe = _voice_pipeline(rest, "legacy")
        voc = Voc(
            pipe.voice_dir,
            pipe.raw_synth_dir,
            pipe.results_dir / "legacy",
            tts=pipe.tts,
            voice_name=cfg.azure_voice_name,
            device=args.device,
        )
        print(voc.run_pipeline())
        return 0
    if cmd == "abtest":
        from .core.config import load_config
        from .eval.abtest import prepare_ab_test

        ap = _parser("abtest", device=False)
        ap.add_argument("--config", default="config.yaml")
        args = ap.parse_args(rest)
        cfg = load_config(args.config)
        ab = cfg.ab_test
        chunks = prepare_ab_test(
            cfg.out_path / "results",
            cfg.data_path,
            cfg.base_dir / ab.get("output_dir", "Out/AB_test"),
            voices=ab.get("voices"),
            num_pairs=ab.get("num_pairs", 44),
            target_duration_s=ab.get("target_duration_s", 60),
            margin_s=ab.get("margin_s", 15),
        )
        print(f"exported {len(chunks)} AB pairs")
        return 0
    if cmd == "viz":
        from .viz.server import main as viz_main

        return viz_main(rest)
    if cmd == "analyze":
        from .eval.dataset_stats import analyze_dataset

        ap = _parser("analyze", device=False)
        ap.add_argument("corpus_dir")
        args = ap.parse_args(rest)
        print(json.dumps(analyze_dataset(args.corpus_dir), indent=2, ensure_ascii=False))
        return 0
    if cmd == "corpus":
        from .audio.corpus import build_natural_corpus

        ap = _parser("corpus", device=False)
        ap.add_argument("data_dir")
        ap.add_argument("out_dir")
        args = ap.parse_args(rest)
        print(f"{build_natural_corpus(args.data_dir, args.out_dir)} pairs")
        return 0
    if cmd == "eval":
        from .core.config import load_config
        from .eval.evaluate_voice import evaluate_all

        ap = _parser("eval")
        ap.add_argument("--config", default="config.yaml")
        args = ap.parse_args(rest)
        cfg = load_config(args.config)
        summary = evaluate_all(cfg.out_path, cfg.data_path, cfg.out_path / "evaluation.json", device=args.device)
        print(json.dumps(summary, indent=2))
        return 0
    if cmd in ("train-break", "train-bilstm", "fewshot", "cascade"):
        from .models import experiment

        ap = _parser(cmd, device=cmd != "fewshot")
        ap.add_argument("--bdd", required=True, help="path to bdd.json")
        ap.add_argument("--out", default="Out/experiments")
        ap.add_argument("--runs", type=int, default=10)
        ap.add_argument("--epochs", type=int, default=10)
        ap.add_argument("--tiny", action="store_true")
        ap.add_argument("--fewshot-config")
        args = ap.parse_args(rest)
        if cmd == "train-break":
            rep = experiment.run_break_experiment(args.bdd, args.out, runs=args.runs, epochs=args.epochs, tiny=args.tiny,
                                                  device=args.device)
        elif cmd == "train-bilstm":
            rep = experiment.run_bilstm_experiment(args.bdd, args.out, epochs=args.epochs, device=args.device)
        elif cmd == "fewshot":
            from .models.fewshot import ExperimentConfig

            fcfg = ExperimentConfig.from_yaml(args.fewshot_config) if args.fewshot_config else None
            rep = experiment.run_fewshot_experiment(args.bdd, args.out, config=fcfg)
        else:
            rep = experiment.run_cascade_experiment(args.bdd, args.out, epochs=args.epochs, tiny=True, device=args.device)
        print(json.dumps(rep, indent=2, default=str)[:2000])
        return 0
    if cmd == "train-ctc":
        from .align.train_ctc import train_ctc_aligner

        ap = _parser("train-ctc")
        ap.add_argument("--corpus", required=True, help="dir of wav+txt pairs")
        ap.add_argument("--out", default="ctc_aligner.npz")
        ap.add_argument("--epochs", type=int, default=20)
        args = ap.parse_args(rest)
        _, losses = train_ctc_aligner(args.corpus, args.out, epochs=args.epochs, device=args.device)
        print(f"final loss {losses[-1]:.3f} -> {args.out}")
        return 0
    if cmd == "pretrain-ctc":
        from .align.pretrain_ctc import PACKAGED_WEIGHTS, pretrain

        ap = _parser("pretrain-ctc")
        ap.add_argument("--out", default=str(PACKAGED_WEIGHTS))
        ap.add_argument("--sentences", type=int, default=384)
        ap.add_argument("--epochs", type=int, default=30)
        ap.add_argument("--batch", type=int, default=8)
        args = ap.parse_args(rest)
        _, err_ms = pretrain(args.out, n_sentences=args.sentences, epochs=args.epochs, batch=args.batch, device=args.device)
        print(f"held-out boundary error {err_ms:.1f} ms -> {args.out}")
        return 0
    if cmd == "pretrain-whisper":
        from .align.pretrain_whisper import PACKAGED_DIR, pretrain

        ap = _parser("pretrain-whisper")
        ap.add_argument("--out", default=str(PACKAGED_DIR))
        ap.add_argument("--sentences", type=int, default=1536)
        ap.add_argument("--epochs", type=int, default=12)
        ap.add_argument("--batch", type=int, default=16)
        ap.add_argument("--domain", default="mixed2", choices=("synth", "formant", "mixed", "mixed2"))
        args = ap.parse_args(rest)
        _, err_ms, acc = pretrain(args.out, n_sentences=args.sentences, epochs=args.epochs, batch=args.batch,
                                  domain=args.domain, device=args.device)
        print(f"held-out boundary error {err_ms:.1f} ms, word acc {acc:.3f} -> {args.out}")
        return 0
    if cmd == "pretrain-masknet":
        from .audio.separate import PACKAGED_WEIGHTS, pretrain_masknet

        ap = _parser("pretrain-masknet")
        ap.add_argument("--out", default=str(PACKAGED_WEIGHTS))
        ap.add_argument("--mixtures", type=int, default=256)
        ap.add_argument("--epochs", type=int, default=10)
        ap.add_argument("--plain", action="store_true", help="round-2 chords-only recipe")
        args = ap.parse_args(rest)
        _, gain = pretrain_masknet(args.out, n_mixtures=args.mixtures, epochs=args.epochs, realistic=not args.plain,
                                   device=args.device)
        print(f"held-out SI-SNR gain {gain:.2f} dB -> {args.out}")
        return 0
    if cmd == "pretrain-pos":
        from .models.pos_data import generate_treebank
        from .models.pos_tagger import PACKAGED_WEIGHTS, save_tagger, train_pos_tagger

        ap = _parser("pretrain-pos")
        ap.add_argument("--out", default=str(PACKAGED_WEIGHTS))
        ap.add_argument("--sentences", type=int, default=16000)
        ap.add_argument("--steps", type=int, default=900)
        args = ap.parse_args(rest)
        sents = generate_treebank(args.sentences, seed=0)
        params, feat, cfg = train_pos_tagger(sents, steps=args.steps, device=args.device)
        save_tagger(params, feat, cfg, args.out)
        print(f"saved -> {args.out}")
        return 0
    if cmd == "agreement":
        # label-free cross-aligner agreement over a real corpus
        # (eval/real_audio_agreement.py; framing of the reference's gold
        # harness, Code/whisper_testing/splitting.py:130-252)
        from .eval.real_audio_agreement import corpus_agreement_report

        ap = _parser("agreement")
        ap.add_argument("--corpus", required=True, help="dir of the corpus's wavs")
        ap.add_argument("--out", default="-", help="JSON path or - for stdout")
        ap.add_argument("--refs", default=None, help="JSON file {stem: nominal_reference_text} anchoring the WER proxy")
        args = ap.parse_args(rest)
        wavs = sorted(Path(args.corpus).glob("*.wav"))
        refs = json.loads(Path(args.refs).read_text(encoding="utf-8")) if args.refs else None
        report = corpus_agreement_report(wavs, refs, device=args.device)
        text = json.dumps(report, indent=1)
        if args.out == "-":
            print(text)
        else:
            Path(args.out).write_text(text, encoding="utf-8")
            print(json.dumps(report["summary"], indent=1))
        return 0
    if cmd == "bench":
        print("bench: the port has no benchmark of its own yet; chip_smoke.py at the repository root drives "
              "every path on the card and times its kernels", file=sys.stderr)
        return 1
    print(f"unknown command {cmd!r}\n{__doc__}")
    return 1


if __name__ == "__main__":
    sys.exit(main() or 0)

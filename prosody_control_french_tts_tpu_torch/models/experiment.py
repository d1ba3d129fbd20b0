"""Experiment drivers: the model-training/eval ``main()``s of the reference
as callable entry points, on the card by default.

- ``run_break_experiment``   pause_bert.main (bootstrap mean±std report)
- ``run_bilstm_experiment``  bilstm seq-len sweep report
- ``run_fewshot_experiment`` fewshot/model.py main (per-model fan-out,
  result JSONs, consolidated HTML)
- ``run_cascade_experiment`` QwenA/B train + test metrics
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

import numpy as np

from .tokenizer import WordPieceTokenizer

log = logging.getLogger(__name__)


def _tokenizer_for(bdd: dict, vocab_size: int = 4000) -> WordPieceTokenizer:
    from .datasets import iter_voice_entries, sequence_to_prosody_rows

    texts = [r["text"] for _, s in iter_voice_entries(bdd) for r in sequence_to_prosody_rows(s)]
    return WordPieceTokenizer.train(texts or ["vide"], vocab_size=vocab_size, min_freq=1)


def run_break_experiment(bdd_path: str | Path, out_dir: str | Path, runs: int = 10, epochs: int = 10, tiny: bool = False,
                         device="cuda") -> dict:
    """Bootstrap the break tagger, then write ``break_report.json``,
    ``tokenizer.json`` and the best run's ``break_tagger.npz`` (the flat
    ``params/a/b/c`` keys of the JAX package's checkpoints, which its
    ``load_params`` reads)."""
    from ..convert import bert_params_to_jax
    from .bert import BertConfig, BreakTagger
    from .break_trainer import bootstrap_runs, sentences_per_second
    from .datasets import build_break_dataset, load_bdd

    bdd = load_bdd(bdd_path)
    tok = _tokenizer_for(bdd)
    cfg = BertConfig.tiny(vocab_size=len(tok)) if tiny else BertConfig(vocab_size=len(tok))
    report = bootstrap_runs(bdd, tok, cfg, runs=runs, epochs=epochs, device=device)
    best = report.pop("best_params")
    cfg_out = report.pop("config")
    ds = build_break_dataset(bdd, tok, max_len=cfg.max_len)
    if best is not None:
        model = BreakTagger(cfg_out, seed=None, device=device).eval()
        report["sentences_per_second"] = sentences_per_second(model, best, ds, device=device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "break_report.json").write_text(json.dumps(report, indent=2), encoding="utf-8")
    tok.save(out_dir / "tokenizer.json")
    if best is not None:
        np.savez(out_dir / "break_tagger.npz", **bert_params_to_jax(best, cfg_out))
    return report


def run_bilstm_experiment(bdd_path: str | Path, out_dir: str | Path, seq_lens=(1, 2, 3, 4), epochs: int = 40,
                          device="cuda") -> list[dict]:
    from .bilstm_runner import seq_len_sweep
    from .datasets import load_bdd

    bdd = load_bdd(bdd_path)
    tok = _tokenizer_for(bdd)
    reports = [dataclasses.asdict(r) for r in seq_len_sweep(bdd, seq_lens=seq_lens, tokenizer=tok, epochs=epochs,
                                                            device=device)]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "bilstm_report.json").write_text(json.dumps(reports, indent=2), encoding="utf-8")
    return reports


def run_fewshot_experiment(
    bdd_path: str | Path,
    out_dir: str | Path,
    config=None,
    clients: dict | None = None,
) -> dict:
    """Per-model experiments → result JSONs + consolidated HTML
    (fewshot/model.py:1109-1151 flow; clients default to deterministic
    stubs so the experiment runs hermetically, Ollama via config)."""
    from . import fewshot as fs
    from .datasets import load_bdd
    from .report_html import write_comparison_html

    cfg = config or fs.ExperimentConfig()
    bdd = load_bdd(bdd_path)
    samples = fs.samples_from_bdd(bdd)[: cfg.num_samples]
    few = None
    if cfg.mode == "fewshot" and len(samples) > cfg.num_few_shot_examples:
        few = [(s["segments"], s["segments"]) for s in samples[: cfg.num_few_shot_examples]]
        samples = samples[cfg.num_few_shot_examples :]

    if clients is None:
        clients = {
            name: (fs.OllamaClient(name) if name != "stub" else fs.StubLLM(noise=1.0))
            for name in cfg.models
        }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {}

    def run_one(item):
        name, client = item
        res, _preds = fs.run_experiment(client, samples, few, cfg.parallel_requests)
        return name, res

    # concurrency across models (the reference fans out one OS process per
    # model, fewshot/model.py:1145; network-bound clients thread cleanly)
    if cfg.num_processes > 1 and len(clients) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cfg.num_processes) as ex:
            finished = list(ex.map(run_one, clients.items()))
    else:
        finished = [run_one(it) for it in clients.items()]
    for name, res in finished:
        results[name] = res.as_dict()
        (out_dir / f"result_{name}.json").write_text(
            json.dumps(results[name], indent=2), encoding="utf-8"
        )
        log.info("%s: break F1 %.3f, parse failures %d", name, res.break_f1, res.parse_failures)
    write_comparison_html(results, out_dir / "comparison.html")
    return results


def run_cascade_experiment(bdd_path: str | Path, out_dir: str | Path, epochs: int = 5, tiny: bool = True,
                           device="cuda") -> dict:
    from . import cascade, llm_eval
    from .datasets import load_bdd, qwen_a_pairs, qwen_b_triples, split_80_10_10
    from .llm import LLMConfig

    bdd = load_bdd(bdd_path)
    tok = _tokenizer_for(bdd)
    report: dict = {}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def _split(items):
        s = split_80_10_10(items)
        if not s["train"]:  # tiny corpora: train on everything, eval on it too
            s = {"train": items, "val": [], "test": items}
        if not s["test"]:
            s["test"] = s["train"]
        return s

    pairs_a = _split(qwen_a_pairs(bdd))
    if pairs_a["train"]:
        cfg = LLMConfig(vocab_size=len(tok), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=256) if tiny else LLMConfig.qwen25_7b(len(tok))
        model_a, _params_a, losses = cascade.train_stage(
            pairs_a["train"], tok, task=cascade.TASK_A, cfg=cfg, epochs=epochs, device=device
        )
        preds = [
            cascade.generate(model_a, tok, cascade.TASK_A, p["x"], max_new=96, device=device)
            for p in pairs_a["test"][:16]
        ]
        refs = [p["y"] for p in pairs_a["test"][:16]]
        report["stage_a"] = dataclasses.asdict(llm_eval.evaluate_stage_a(preds, refs))
        report["stage_a"]["final_train_loss"] = losses[-1] if losses else None

    triples = _split(qwen_b_triples(bdd))
    if triples["train"]:
        cfg_b = LLMConfig(vocab_size=len(tok), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=384)
        model_b, _params_b, _ = cascade.train_stage(
            triples["train"], tok, task=cascade.TASK_B, cfg=cfg_b, epochs=epochs, x_key="z", y_key="y", device=device
        )
        preds = [
            cascade.generate(model_b, tok, cascade.TASK_B, p["z"], max_new=160, device=device)
            for p in triples["test"][:8]
        ]
        refs = [p["y"] for p in triples["test"][:8]]
        report["stage_b"] = dataclasses.asdict(llm_eval.evaluate_stage_b(preds, refs))

    (out_dir / "cascade_report.json").write_text(json.dumps(report, indent=2), encoding="utf-8")
    return report

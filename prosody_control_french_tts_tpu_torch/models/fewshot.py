"""Zero-/few-shot SSML prediction harness.

The counterpart of Code/ssml_models/fewshot/model.py: prompt an
instruction LLM with text segments, parse its JSON prosody predictions
(with the reference's multi-strategy repair, :182-250), rebuild SSML, and
score against gold (break P/R/F1, per-parameter MAE/MSE, R², tag-usage
stats, :569-810).

The LLM behind the harness is a protocol: the in-framework decoder
(``LocalLLMClient`` over ``models.llm.greedy_generate``, on the card by
default), an Ollama HTTP server
(``OllamaClient`` — the reference's backend), or a deterministic stub for
tests. Requests fan out over a thread pool exactly like the reference's
``parallel_requests`` (:603).
"""

from __future__ import annotations

import json
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from ..ops.kernels import resolve_device


# ---------------------------------------------------------------------------
# config (fewshot/config.yaml schema)
# ---------------------------------------------------------------------------


@dataclass
class ExperimentConfig:
    models: list[str] = field(default_factory=lambda: ["local"])
    num_samples: int = 100
    num_few_shot_examples: int = 10
    parallel_requests: int = 5
    num_processes: int = 1
    mode: str = "fewshot"  # zeroshot | fewshot

    @classmethod
    def from_yaml(cls, path: str) -> "ExperimentConfig":
        import yaml  # only the YAML entry point needs PyYAML

        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}
        return cls(
            models=cfg.get("models", ["local"]),
            num_samples=cfg.get("num_samples", 100),
            num_few_shot_examples=cfg.get("num_few_shot_examples", 10),
            parallel_requests=cfg.get("parallel_requests", 5),
            num_processes=cfg.get("num_processes", 1),
            mode=cfg.get("mode", "fewshot"),
        )


# ---------------------------------------------------------------------------
# LLM clients
# ---------------------------------------------------------------------------


class LLMClient(Protocol):
    def complete(self, prompt: str) -> str:  # pragma: no cover - protocol
        ...


class OllamaClient:
    """The reference's backend, over stdlib HTTP (model.py uses
    langchain_ollama; the wire protocol is POST /api/generate)."""

    def __init__(self, model: str, host: str = "http://localhost:11434", timeout_s: float = 120.0):
        self.model = model
        self.host = host
        self.timeout_s = timeout_s

    def complete(self, prompt: str) -> str:
        import urllib.request

        req = urllib.request.Request(
            f"{self.host}/api/generate",
            data=json.dumps({"model": self.model, "prompt": prompt, "stream": False}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read())["response"]


class StubLLM:
    """Deterministic client for tests: answers with the gold segments it
    finds embedded in the prompt, optionally perturbed."""

    def __init__(self, noise: float = 0.0, seed: int = 0):
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def complete(self, prompt: str) -> str:
        m = re.search(r"INPUT_SEGMENTS:\s*(\[.*?\])\s*$", prompt, re.DOTALL)
        segments = json.loads(m.group(1)) if m else []
        out = []
        for seg in segments:
            out.append(
                {
                    "text": seg["text"],
                    "pitch": f"{self.rng.normal(0, self.noise):+.2f}%",
                    "rate": f"{self.rng.normal(0, self.noise):+.2f}%",
                    "volume": f"{self.rng.normal(0, self.noise):+.2f}%",
                    "break_after_ms": 0,
                }
            )
        return json.dumps(out)


class LocalLLMClient:
    """Serve the in-framework decoder LM (greedy, KV-cached) on ``device``,
    where the model must already be."""

    def __init__(self, model, tokenizer, max_new: int = 256, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.tokenizer = tokenizer
        self.max_new = max_new

    def complete(self, prompt: str) -> str:
        from .llm import greedy_generate

        ids = self.tokenizer.encode(prompt)[-self.model.cfg.max_len // 2 :]
        toks = greedy_generate(
            self.model, np.asarray([ids], np.int32), self.max_new, eos_id=self.tokenizer.sep_id, device=self.device
        )
        return self.tokenizer.decode(toks[0, len(ids) :].tolist())


# ---------------------------------------------------------------------------
# JSON repair (model.py:182-250 four-strategy parser)
# ---------------------------------------------------------------------------


def parse_json_response(text: str):
    """Parse an LLM's JSON with progressive repair: 1) direct; 2) first
    [...] block; 3) strip code fences / think tags; 4) line-wise object
    scavenging."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    m = re.search(r"\[.*\]", text, re.DOTALL)
    if m:
        try:
            return json.loads(m.group(0))
        except json.JSONDecodeError:
            pass
    cleaned = re.sub(r"```(?:json)?|```", "", text)
    cleaned = re.sub(r"<think>.*?</think>", "", cleaned, flags=re.DOTALL)
    try:
        return json.loads(cleaned.strip())
    except json.JSONDecodeError:
        pass
    objs = []
    for m in re.finditer(r"\{[^{}]*\}", text, re.DOTALL):
        try:
            objs.append(json.loads(m.group(0)))
        except json.JSONDecodeError:
            continue
    return objs


# ---------------------------------------------------------------------------
# prediction + SSML building
# ---------------------------------------------------------------------------

_PROMPT = """You are a French TTS prosody annotator. For each input segment,
predict SSML prosody adjustments as JSON: a list of objects with keys
"text", "pitch", "rate", "volume" (signed percents like "+1.25%") and
"break_after_ms" (integer milliseconds, 0 for none).
Answer with JSON only.
{examples}INPUT_SEGMENTS: {segments}"""


def build_prompt(segments: list[dict], examples: list[tuple[list, list]] | None = None) -> str:
    ex = ""
    if examples:
        parts = []
        for inp, out in examples:
            parts.append(f"INPUT_SEGMENTS: {json.dumps(inp, ensure_ascii=False)}\n{json.dumps(out, ensure_ascii=False)}")
        ex = "EXAMPLES:\n" + "\n".join(parts) + "\n"
    return _PROMPT.format(examples=ex, segments=json.dumps(segments, ensure_ascii=False))


def predictions_to_ssml(preds: list[dict], voice: str = "fr-FR-HenriNeural") -> str:
    """SSML builder (model.py:447-480 equivalent)."""
    parts = []
    for p in preds:
        pitch = p.get("pitch", "+0.00%")
        rate = p.get("rate", "+0.00%")
        volume = p.get("volume", "+0.00%")
        parts.append(
            f'<prosody pitch="{pitch}" rate="{rate}" volume="{volume}">{p.get("text", "")}</prosody>'
        )
        brk = int(p.get("break_after_ms", 0) or 0)
        if brk > 0:
            parts.append(f'<break time="{brk}ms"/>')
    body = "".join(parts)
    return (
        '<speak xmlns="http://www.w3.org/2001/10/synthesis" version="1.0" xml:lang="fr-FR">'
        f'<voice name="{voice}">{body}</voice></speak>'
    )


# ---------------------------------------------------------------------------
# evaluation (model.py:569-810)
# ---------------------------------------------------------------------------


def _pct(s) -> float:
    if isinstance(s, (int, float)):
        return float(s)
    m = re.match(r"\s*([+-]?\d+(?:\.\d+)?)\s*%", str(s or ""))
    return float(m.group(1)) if m else 0.0


@dataclass
class EvalResult:
    break_precision: float
    break_recall: float
    break_f1: float
    mae: dict[str, float]
    mse: dict[str, float]
    r2: dict[str, float]
    tags_per_sentence: float
    parse_failures: int
    n: int
    gold_breaks: int = 0
    pred_breaks: int = 0

    def as_dict(self) -> dict:
        return self.__dict__.copy()


def evaluate_predictions(samples: list[dict], predictions: list) -> EvalResult:
    """samples: [{segments: [{text,pitch,rate,volume,break_after_ms}]}];
    predictions: parsed LLM outputs (lists of dicts) aligned by index."""
    gold_vals = {k: [] for k in ("pitch", "rate", "volume")}
    pred_vals = {k: [] for k in ("pitch", "rate", "volume")}
    tp = fp = fn = 0
    parse_failures = 0
    total_tags = 0
    total_sentences = 0

    for sample, pred in zip(samples, predictions):
        gold = sample["segments"]
        total_sentences += len(gold)
        if not isinstance(pred, list) or not pred:
            parse_failures += 1
            fn += sum(1 for g in gold if int(g.get("break_after_ms", 0) or 0) > 0)
            continue
        for i, g in enumerate(gold):
            p = pred[i] if i < len(pred) and isinstance(pred[i], dict) else {}
            for k in ("pitch", "rate", "volume"):
                gold_vals[k].append(_pct(g.get(k)))
                pred_vals[k].append(_pct(p.get(k)))
            g_brk = int(g.get("break_after_ms", 0) or 0) > 0
            p_brk = int(p.get("break_after_ms", 0) or 0) > 0
            tp += g_brk and p_brk
            fp += (not g_brk) and p_brk
            fn += g_brk and (not p_brk)
            total_tags += 3 + int(p_brk)

    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    gold_breaks = tp + fn
    pred_breaks = tp + fp

    mae, mse, r2 = {}, {}, {}
    for k in gold_vals:
        g = np.asarray(gold_vals[k])
        p = np.asarray(pred_vals[k])
        if g.size == 0:
            mae[k] = mse[k] = r2[k] = 0.0
            continue
        mae[k] = float(np.mean(np.abs(g - p)))
        mse[k] = float(np.mean((g - p) ** 2))
        ss_res = float(np.sum((g - p) ** 2))
        ss_tot = float(np.sum((g - g.mean()) ** 2))
        r2[k] = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    return EvalResult(
        break_precision=prec,
        break_recall=rec,
        break_f1=f1,
        mae=mae,
        mse=mse,
        r2=r2,
        tags_per_sentence=total_tags / max(total_sentences, 1),
        parse_failures=parse_failures,
        n=len(samples),
        gold_breaks=gold_breaks,
        pred_breaks=pred_breaks,
    )


def run_experiment(
    client: LLMClient,
    samples: list[dict],
    few_shot_examples: list[tuple[list, list]] | None = None,
    parallel_requests: int = 5,
) -> tuple[EvalResult, list]:
    """Fan predictions out over a thread pool (model.py:603-606) and score."""

    def predict(sample):
        prompt = build_prompt(sample["segments"], few_shot_examples)
        try:
            return parse_json_response(client.complete(prompt))
        except Exception:  # noqa: BLE001 — failures count as parse failures
            return None

    with ThreadPoolExecutor(max_workers=parallel_requests) as ex:
        preds = list(ex.map(predict, samples))
    return evaluate_predictions(samples, preds), preds


def samples_from_bdd(bdd: dict, max_segments: int = 8) -> list[dict]:
    """Group parsed_sequence rows into eval samples
    (model.py:1062-1106 groups by segment id)."""
    from .datasets import iter_voice_entries

    samples = []
    for _, seq in iter_voice_entries(bdd):
        by_seg: dict[str, list[dict]] = {}
        pending_break: dict[str, bool] = {}
        for item in seq:
            seg = item.get("segment", "?")
            if item["type"] == "text":
                by_seg.setdefault(seg, []).append(
                    {
                        "text": item["text"],
                        "pitch": item.get("prosody", {}).get("pitch", "+0.00%"),
                        "rate": item.get("prosody", {}).get("rate", "+0.00%"),
                        "volume": item.get("prosody", {}).get("volume", "+0.00%"),
                        "break_after_ms": 0,
                    }
                )
            elif item["type"] == "break":
                rows = by_seg.get(seg)
                if rows:
                    ms = re.match(r"(\d+)", str(item.get("time", "0")))
                    rows[-1]["break_after_ms"] = int(ms.group(1)) if ms else 0
        for seg, rows in by_seg.items():
            for i in range(0, len(rows), max_segments):
                samples.append({"segment": seg, "segments": rows[i : i + max_segments]})
    return samples

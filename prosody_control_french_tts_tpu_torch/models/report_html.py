"""Consolidated HTML comparison viewer for model experiments.

Parity with the few-shot harness's report generator
(Code/ssml_models/fewshot/model.py:857-1058): one self-contained HTML file
with a metric table per model, per-parameter error bars, and sample-level
prediction/gold SSML side-by-sides. Stdlib only: the port's own copy of
the JAX package's module.
"""

from __future__ import annotations

import html
import json
from pathlib import Path


def _metric_rows(results: dict[str, dict]) -> str:
    cols = ["break_f1", "break_precision", "break_recall", "tags_per_sentence", "parse_failures", "n"]
    head = "".join(f"<th>{c}</th>" for c in ["model"] + cols + ["mae(p/r/v)", "r2(p/r/v)"])
    rows = []
    for model, res in results.items():
        cells = [f"<td><b>{html.escape(model)}</b></td>"]
        for c in cols:
            v = res.get(c, "")
            cells.append(f"<td>{v:.3f}</td>" if isinstance(v, float) else f"<td>{v}</td>")
        mae = res.get("mae", {})
        r2 = res.get("r2", {})
        cells.append(
            "<td>" + "/".join(f"{mae.get(k, 0):.2f}" for k in ("pitch", "rate", "volume")) + "</td>"
        )
        cells.append(
            "<td>" + "/".join(f"{r2.get(k, 0):.2f}" for k in ("pitch", "rate", "volume")) + "</td>"
        )
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return f"<table><tr>{head}</tr>{''.join(rows)}</table>"


def _samples_section(samples: list[dict], max_samples: int = 20) -> str:
    blocks = []
    for s in samples[:max_samples]:
        blocks.append(
            "<details><summary>"
            + html.escape(s.get("id", "?"))
            + "</summary><pre class='gold'>"
            + html.escape(s.get("gold", ""))
            + "</pre><pre class='pred'>"
            + html.escape(s.get("pred", ""))
            + "</pre></details>"
        )
    return "".join(blocks)


_CSS = """
body{font-family:system-ui,sans-serif;margin:2rem;background:#fafafa}
table{border-collapse:collapse;margin:1rem 0}
td,th{border:1px solid #ccc;padding:.35rem .6rem;text-align:right}
th{background:#eee}
pre{background:#fff;border:1px solid #ddd;padding:.5rem;white-space:pre-wrap}
pre.gold{border-left:4px solid #2a7}
pre.pred{border-left:4px solid #d72}
details{margin:.3rem 0}
"""


def write_comparison_html(
    results: dict[str, dict],
    out_path: str | Path,
    samples: dict[str, list[dict]] | None = None,
    title: str = "SSML prediction comparison",
) -> Path:
    """results: {model_name: EvalResult.as_dict()}; samples (optional):
    {model_name: [{id, gold, pred}]}."""
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title><style>{_CSS}</style>",
        f"<h1>{html.escape(title)}</h1>",
        _metric_rows(results),
    ]
    for model, sm in (samples or {}).items():
        parts.append(f"<h2>{html.escape(model)}</h2>")
        parts.append(_samples_section(sm))
    parts.append(
        "<script>window.__results = " + json.dumps(results, default=str) + ";</script>"
    )
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(parts), encoding="utf-8")
    return out

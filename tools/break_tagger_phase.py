#!/usr/bin/env python3
"""The break-predictor serving path alone: phase 20 of ``chip_smoke.py``.

    python3 tools/break_tagger_phase.py [--seed 0] [--turns N]

Run from the root of a checkout on a machine with an NVIDIA H100. It runs
``chip_smoke.break_tagger_phase`` at bert-base width (card against CPU,
``sentences_per_second`` at B 256, L 128, the HTTP service batched and
unbatched under bench.py's load, the prosody head, the experiment drivers,
ten ``train_tagger`` steps at B 64) without the phases before it. The
experiment drivers read a synthetic ``bdd.json`` (40 segments of 8 text runs
of three words from a 16-word vocabulary, a break after every third run, a
period every fourth: ``tests/test_harnesses.py:make_bdd``'s recipe) instead
of the multi-voice run's. Prints the card, the phase's lines and its result
as one JSON line. ``--turns N`` serves instead N rounds of four turns in one
process, each on a new predictor closed after it: batched with the CUDA
graphs, batched with the forward run eagerly (the design before the
per-bucket graphs), unbatched eager, unbatched graphs; one JSON line a turn.
Before each turn ``faulthandler.dump_traceback_later`` is armed, so a turn
that does not end within TURN_LIMIT_S seconds prints every thread's stack
and ends the process with a non-zero code.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VOCAB = ["bonjour", "monde", "voix", "parle", "bien", "fort", "doux", "vite",
         "chat", "chien", "maison", "rouge", "vert", "bleu", "grand", "petit"]


def synthetic_bdd(n_segments: int = 40, runs_per: int = 8, break_every: int = 3, seed: int = 0) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = []
    for s in range(n_segments):
        for w in range(runs_per):
            seq.append({"segment": f"segment_ph{s + 1}", "type": "text",
                        "text": " ".join(rng.choice(VOCAB, size=3)) + ("." if w % 4 == 3 else ""),
                        "prosody": {"pitch": f"{rng.normal(0, 1):+.2f}%", "rate": f"{rng.normal(0, 2):+.2f}%",
                                    "volume": f"{rng.normal(0, 3):+.2f}%"}})
            if w % break_every == break_every - 1:
                seq.append({"segment": f"segment_ph{s + 1}", "type": "break", "time": "250ms"})
    return {"voice1": {"x": "", "y": {"parsed_sequence": seq, "stripped_ssml": {}, "raw_ssml": {}}}}


def eager_forward(self, ids, mask):
    """``SSMLPredictor._forward`` without its CUDA graphs: ~500 launches
    from Python a flush."""
    import torch

    with torch.inference_mode():
        ids_d, mask_d = torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        return self._outputs(ids_d, mask_d).cpu().numpy()


SERVING = {"batched": (64, 4.0), "unbatched": (1, 0.0)}
TURN_LIMIT_S = 120.0  # far above the longest turn, unbatched eager (~46 s)


def serving_setup(seed: int):
    import numpy as np

    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.models.bert import BertConfig, BreakTagger
    from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer

    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(cs.BERT_WORDS, size=int(rng.integers(6, 14))))
             for _ in range(cs.SERVE_CLIENTS * cs.SERVE_PER_CLIENT)]
    tok = WordPieceTokenizer.train([" ".join(cs.BERT_WORDS)], vocab_size=512, min_freq=1)
    cfg = BertConfig(vocab_size=max(len(tok), 512))
    return texts, tok, cfg, BreakTagger(cfg, seed=seed, device="cpu").state_dict()


def serve_turn(setup, label: str, turn: str) -> dict:
    """One turn: a new predictor, bench.py's load, the predictor closed."""
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.serving.predictor import SSMLPredictor

    texts, tok, cfg, state = setup
    max_batch, wait_ms = SERVING[label]
    svc = SSMLPredictor(tok, cfg, state, device="cuda", max_batch=max_batch, max_wait_ms=wait_ms)
    if turn == "eager":
        svc._forward = eager_forward.__get__(svc)
    try:
        r = cs.serve_load(svc, texts, cs.SERVE_CLIENTS, cs.SERVE_PER_CLIENT)
    finally:
        closed = svc.close()
    return {"serving": label, "forward": turn, **r, "closed_clean": closed}


def hang_turns(card: str, seed: int, rounds: int) -> None:
    import faulthandler
    import threading
    import time

    import torch

    setup = serving_setup(seed)
    done = {"graphs": 0, "eager": 0}
    for i in range(rounds):
        for label, turn in (("batched", "graphs"), ("batched", "eager"), ("unbatched", "eager"),
                            ("unbatched", "graphs")):
            faulthandler.dump_traceback_later(TURN_LIMIT_S, exit=True)
            t0 = time.perf_counter()
            r = serve_turn(setup, label, turn)
            faulthandler.cancel_dump_traceback_later()
            done[turn] += 1
            print(json.dumps({"round": i, "serving": label, "forward": turn, "turn_s": round(time.perf_counter() - t0, 3),
                              "sentences_per_s": round(r["sentences_per_s"], 1), "p50_ms": round(r["p50_ms"], 2),
                              "closed_clean": r["closed_clean"], "threads_after": threading.active_count(),
                              "allocated_mib": round(torch.cuda.memory_allocated() / 2**20, 1)}), flush=True)
    print(json.dumps({"hang_turns": done, "hung": 0, "turn_limit_s": TURN_LIMIT_S, "card": card}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=0, help="serve N rounds of four turns instead of the phase")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("break_tagger_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    if args.turns:
        hang_turns(card, args.seed, args.turns)
        return 0
    out = chip_smoke.break_tagger_phase(card, args.seed, json.dumps(synthetic_bdd(seed=args.seed)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The break-tagger service on the card: a predictor built while another one
serves in the same process, as a model reload or a second service does.

    python -m pytest --noconftest -m gpu tests/test_torch_serving_gpu.py -q

A predictor on the card captures its CUDA graphs when it is built, on the
building thread, while the serving predictor's finisher threads replay theirs
and read their results back. Without a card the case skips.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu_torch.models.bert import BertConfig, BreakTagger
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer
from prosody_control_french_tts_tpu_torch.serving.predictor import SSMLPredictor

WORDS = ["bonjour", "le", "monde", "la", "voix", "parle", "bien", "fort", "un", "deux", "trois", "chat", "chien",
         "maison", "rouge", "vert", "grand", "petit", "doucement", "merci"]
CLIENTS = 8
BUILDS = 3


@pytest.mark.gpu
def test_a_predictor_is_built_while_another_serves():
    """Eight client threads keep a predictor busy while three more predictors
    are built, checked and closed one after another. Every request is
    answered, and each new predictor's answers, one text at a time, equal the
    serving predictor's answers to the same texts before the load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the predictor's CUDA graphs have no CPU mode")
    tok = WordPieceTokenizer.train([" ".join(WORDS)], vocab_size=128, min_freq=1)
    cfg = BertConfig.tiny(vocab_size=max(len(tok), 128))
    state = BreakTagger(cfg, seed=0, device="cpu").state_dict()
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 14)))) for _ in range(48)]

    serving = SSMLPredictor(tok, cfg, state, device="cuda", max_batch=8, max_wait_ms=2.0)
    want = {t: serving.predict(t)["ssml"] for t in texts[:8]}
    stop, errors, answered = threading.Event(), [], [0] * CLIENTS

    def client(c: int) -> None:
        i = c
        while not stop.is_set():
            try:
                out = serving.predict(texts[i % len(texts)])
                assert out["words"] == texts[i % len(texts)].split()
                answered[c] += 1
            except Exception as e:  # noqa: BLE001 — collected and asserted below
                errors.append(repr(e))
                return
            i += CLIENTS

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(CLIENTS)]
    for th in threads:
        th.start()
    try:
        for _ in range(BUILDS):
            before = sum(answered)
            built = SSMLPredictor(tok, cfg, state, device="cuda", max_batch=8, max_wait_ms=2.0)
            try:
                got = {t: built.predict(t)["ssml"] for t in want}
            finally:
                assert built.close()
            assert got == want
            assert sum(answered) > before, "the serving predictor answered nothing while another was built"
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        closed = serving.close()
    assert not errors, errors[:3]
    assert not any(th.is_alive() for th in threads) and closed

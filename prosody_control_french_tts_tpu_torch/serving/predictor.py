"""SSML prediction service: text → SSML with predicted breaks (+ prosody).

The deployment shape of the trained models: the break tagger marks pause
positions (the reference's pause_bert inference), optionally the BiLSTM
regressor fills pitch/volume/rate percentages, and the SSML builder emits
the document. One forward per micro-batch on the predictor's device (on the
card a CUDA graph per row bucket, every one captured when the predictor is
built), padded to the model's max_len and to a power-of-two row bucket, and
one device→host read of its results.

HTTP front-end (stdlib): POST /ssml {"text": …} | {"texts": […]},
GET /healthz.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..models.bert import BertConfig, BreakTagger
from ..models.tokenizer import WordPieceTokenizer
from ..ops.kernels import resolve_device
from .batcher import MicroBatcher

log = logging.getLogger(__name__)


class SSMLPredictor:
    def __init__(
        self,
        tokenizer: WordPieceTokenizer,
        cfg: BertConfig,
        state: dict,
        device="cuda",
        break_ms: int = 250,
        voice: str = "fr-FR-HenriNeural",
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        prosody: dict | None = None,
    ):
        """``state`` is a ``BreakTagger`` state_dict (``convert.
        bert_params_from_jax`` gives one from a flax tree). ``prosody``
        (optional) enables pitch/rate/volume prediction: {"encoder_state":
        …, "bilstm_state": …, "mu": [3], "sd": [3]} — the BiLSTM regressor
        over ``SentenceEncoder`` embeddings with its z-score calibration
        (models.bilstm)."""
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.model = BreakTagger(cfg, seed=None, device=self.device).eval()
        self.model.load_state_dict(state)
        self.break_ms = break_ms
        self.voice = voice

        self.prosody = prosody
        if prosody is not None:
            from ..models.bert import SentenceEncoder
            from ..models.bilstm import BiLSTMConfig, BiLSTMProsody

            self._enc = SentenceEncoder(cfg, seed=None, device=self.device).eval()
            self._enc.load_state_dict(prosody["encoder_state"])
            self._reg = BiLSTMProsody(BiLSTMConfig(embed_dim=cfg.hidden), seed=None, device=self.device).eval()
            self._reg.load_state_dict(prosody["bilstm_state"])
            self._mu = np.asarray(prosody.get("mu", np.zeros(3)))
            self._sd = np.asarray(prosody.get("sd", np.ones(3)))

        self.max_batch = max_batch
        self._graphs: dict[int, dict] = {}  # row bucket → captured forward (on the card)
        self._graph_lock = threading.Lock()
        if self.device.type == "cuda":
            # every bucket captured here, on the constructing thread: entering
            # torch.cuda.graph synchronises, collects garbage and empties the
            # allocator's cache, none of which may run on a serving thread
            with torch.inference_mode():
                for b in self.bucket_sizes():
                    self._graphs[b] = self._capture(b)
        self.batcher = MicroBatcher(self._predict_batch, max_batch=max_batch, max_wait_ms=max_wait_ms)

    # -- core -----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Pad the micro-batch to the next power of two, clamped to
        max_batch: under live traffic the collected batch size varies per
        flush, and log2(max_batch) shapes cover every load level (each one
        warmed once: cuBLAS picks its algorithms per shape). The clamp
        matters for non-power-of-two max_batch (e.g. 24): the batcher never
        collects more than max_batch, so rounding 17-24 up to 32 would hit a
        shape no warmup covered."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def bucket_sizes(self) -> list[int]:
        """Every leading dimension _predict_batch can produce — the warmup
        set and, on the card, the captured graphs (powers of two up to
        max_batch, plus max_batch itself when it is not a power of two)."""
        sizes = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)
        return sizes

    def _predict_batch(self, texts: list[str]) -> list[dict]:
        L = self.cfg.max_len
        B = self._bucket(len(texts))
        ids = np.full((B, L), self.tokenizer.pad_id, np.int32)
        word_idx = np.full((B, L), -1, np.int32)
        words_per = []
        for i, text in enumerate(texts):
            words = text.split()
            words_per.append(words)
            tok_ids, widx = self.tokenizer.encode_words(words)
            tok_ids, widx = tok_ids[:L], widx[:L]
            ids[i, : len(tok_ids)] = tok_ids
            word_idx[i, : len(widx)] = widx
        # padding rows keep one live token so attention never sees an
        # all-masked row; their outputs are sliced away below
        mask = ids != self.tokenizer.pad_id
        mask[:, 0] = True
        host = self._forward(ids, mask)
        breaks = host[:, :L] > 0.5  # [B, L]
        # pitch, volume, rate percentages, calibrated on the host as the JAX package does
        pros = host[:, L:] * self._sd + self._mu if self.prosody is not None else None

        out = []
        for i, words in enumerate(words_per):
            # vectorized token→word break scatter
            wb = np.zeros(len(words), bool)
            sel = (word_idx[i] >= 0) & breaks[i]
            wb[word_idx[i][sel]] = True
            word_break = wb.tolist()
            entry = {
                "words": words,
                "breaks": word_break,
            }
            p = tuple(float(v) for v in pros[i]) if pros is not None else None
            if p is not None:
                entry["prosody"] = {
                    "pitch": f"{p[0]:+.2f}%",
                    "volume": f"{p[1]:+.2f}%",
                    "rate": f"{p[2]:+.2f}%",
                }
            entry["ssml"] = self._to_ssml(words, word_break, p)
            out.append(entry)
        return out

    def _outputs(self, ids_d: torch.Tensor, mask_d: torch.Tensor) -> torch.Tensor:
        """The models on device tensors → float32 [B, L] (1 where the BREAK
        logit wins: argmax == 1, a tie going to 0 as argmax's), followed by
        the prosody head's three z-scores [B, 3] when it is on."""
        logits = self.model(ids_d, mask_d)
        out = (logits[..., 1] > logits[..., 0]).float()
        if self.prosody is not None:
            emb = self._enc(ids_d, mask_d)  # [B, hidden]
            out = torch.cat([out, self._reg(emb[:, None, :])], 1)
        return out

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One flush's forward, with one device→host read of its outputs.
        This runs on the batcher's finisher threads, and inference mode is
        thread-local, so it opens its own. On the card it replays, under a
        lock, the CUDA graph that the constructor captured for the row
        bucket, and never captures: an eager forward is ~500 launches from
        Python, and with the HTTP threads runnable each op that gives the
        interpreter lock back can wait for it, which made a B 1 forward
        take 50 ms under load. A bucket with no graph raises."""
        with torch.inference_mode():
            if self.device.type != "cuda":
                return self._outputs(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
            with self._graph_lock:
                g = self._graphs.get(ids.shape[0])
                if g is None:
                    raise RuntimeError(f"no CUDA graph for a flush of {ids.shape[0]} rows (buckets "
                                       f"{self.bucket_sizes()}; the predictor may be closed)")
                g["ids"].copy_(torch.from_numpy(ids))
                g["mask"].copy_(torch.from_numpy(mask))
                g["graph"].replay()
                return g["out"].cpu().numpy()

    def _capture(self, B: int) -> dict:
        """Capture the forward of a [B, max_len] flush (the constructor calls
        it in inference mode, before the batcher starts)."""
        L = self.cfg.max_len
        ids = torch.full((B, L), self.tokenizer.pad_id, dtype=torch.int32, device=self.device)
        mask = torch.ones((B, L), dtype=torch.bool, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up off the capture: cuBLAS workspaces, the allocator's blocks
            for _ in range(2):
                self._outputs(ids, mask)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local: another predictor's finishers may read results back
        # (a synchronising call) while this one is being built
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._outputs(ids, mask)
        return {"graph": graph, "ids": ids, "mask": mask, "out": out}

    def _to_ssml(self, words: list[str], word_break: list[bool], pros=None) -> str:
        from ..utils.text import xml_escape

        parts = []
        for w, brk in zip(words, word_break):
            parts.append(xml_escape(w))
            if brk:
                parts.append(f'<break time="{self.break_ms}ms"/>')
        body = " ".join(parts)
        if pros is not None:
            body = (
                f'<prosody pitch="{pros[0]:+.2f}%" rate="{pros[2]:+.2f}%" '
                f'volume="{pros[1]:+.2f}%">{body}</prosody>'
            )
        return (
            '<speak xmlns="http://www.w3.org/2001/10/synthesis" version="1.0" '
            f'xml:lang="fr-FR"><voice name="{self.voice}">{body}</voice></speak>'
        )

    def predict(self, text: str) -> dict:
        return self.batcher.submit(text)

    def close(self, timeout_s: float = 5.0) -> bool:
        """Stop the batcher (a bounded wait) and free the captured graphs here,
        not whenever the garbage collector reaches them: the predictor and
        its batcher hold each other, and a graph freed on some other thread
        could land in the middle of another predictor's capture. Returns
        whether every flush finished and the graphs were freed."""
        done = self.batcher.close(timeout_s)
        if not self._graph_lock.acquire(timeout=timeout_s):
            return False
        try:
            if self._graphs:
                torch.cuda.synchronize(self.device)
            self._graphs.clear()
        finally:
            self._graph_lock.release()
        return done

    # -- HTTP -------------------------------------------------------------
    def make_handler(self):
        svc = self

        class Handler(BaseHTTPRequestHandler):
            # Serving-latency essentials:
            # - HTTP/1.1 keep-alive: the 1.0 default closes the connection
            #   after every response, so each request pays a TCP handshake;
            #   a dropped SYN under concurrent load retransmits after ~1 s.
            # - Nagle off + single-write responses: headers and body written
            #   as separate segments stall ~40 ms on delayed ACK.
            # - A request whose prediction raises is answered too (503 for a
            #   timeout, 500 otherwise), so the connection stays usable.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _json(self, obj, code=200):
                body = json.dumps(obj, ensure_ascii=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self._headers_buffer.append(b"\r\n")  # end_headers' blank line, sent with the body
                self.wfile.write(b"".join(self._headers_buffer) + body)
                self._headers_buffer = []

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    return self._json({"status": "ok"})
                return self._json({"error": "unknown route"}, 404)

            def do_POST(self):  # noqa: N802
                if self.path != "/ssml":
                    return self._json({"error": "unknown route"}, 404)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._json({"error": "invalid JSON"}, 400)
                if "text" in req:
                    texts = [str(req["text"])]
                elif "texts" in req and isinstance(req["texts"], list):
                    texts = [str(t) for t in req["texts"]]
                else:
                    return self._json({"error": "expected 'text' or 'texts'"}, 400)
                # every request gets a JSON answer: a flush that failed or a
                # batcher that timed out is the service's fault, not the client's
                try:
                    out = [svc.predict(t) for t in texts]
                except TimeoutError as e:
                    return self._json({"error": f"timed out: {e}"}, 503)
                except Exception as e:  # noqa: BLE001 — reported to the client, logged with its traceback
                    log.exception("prediction failed")
                    return self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                return self._json(out[0] if "text" in req else out)

        return Handler

    def serve(self, port: int = 8090) -> ThreadingHTTPServer:
        # socketserver's default listen backlog of 5 resets connections
        # when more clients connect at once than accept() keeps up with
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        httpd = _Server(("0.0.0.0", port), self.make_handler())
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        log.info("SSML prediction service on :%d", httpd.server_address[1])
        return httpd

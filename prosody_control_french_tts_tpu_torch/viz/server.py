"""HTTP viewer for segment/AB-test audio and plot data (stdlib http.server).

Parity with the reference's two FastAPI apps
(Code/visualisation/app.py, Code/visualisation_abtest/app.py):

- ``GET /segments``                       list of available segment stems
- ``GET /audio/{kind}/{segment}``         wav bytes (kind: natural|synthetic
                                          or improved|raw for AB mode)
- ``GET /plot_data/{kind}/{segment}``     waveform/spectrogram/F0/intervals
- ``GET /``                               canvas viewer (static/index.html)
- ``GET /abtest`` + ``POST /ab_response`` blind listening test + JSONL log
- ``GET /kinds``                          available corpora
- startup preloading into an in-memory cache on a worker pool
  (visualisation_abtest/app.py:132-151), here a ThreadPoolExecutor: the
  threads share the card and overlap file reads and device work; a plot's
  lists and JSON are built on the host under the interpreter lock.

The plot data is computed on the service's device (CUDA by default).

Run: ``python -m prosody_control_french_tts_tpu_torch viz --natural DIR
--synthetic DIR [--textgrids DIR] [--port 8000] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..ops.kernels import resolve_device
from .plotdata import compute_plot_data

log = logging.getLogger(__name__)


class VizService:
    def __init__(
        self,
        dirs: dict[str, Path],
        textgrid_dirs: dict[str, Path] | None = None,
        ab_log_path: Path | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dirs = {k: Path(v) for k, v in dirs.items()}
        self.textgrid_dirs = {k: Path(v) for k, v in (textgrid_dirs or {}).items()}
        self.cache: dict[tuple[str, str], dict] = {}
        self.lock = threading.Lock()
        self.ab_log_path = Path(ab_log_path) if ab_log_path else None

    def log_ab_response(self, record: dict) -> None:
        """Append one listener judgement (segment, presented order, choice,
        timestamp) — the perceptual-study artifact of the AB protocol
        (config.yaml:64-77)."""
        record = {"t": time.time(), **record}
        line = json.dumps(record, ensure_ascii=False) + "\n"
        with self.lock:
            if self.ab_log_path:
                self.ab_log_path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.ab_log_path, "a", encoding="utf-8") as f:
                    f.write(line)
            else:
                log.info("ab_response %s", line.strip())

    def segments(self) -> list[str]:
        stems = set()
        for d in self.dirs.values():
            stems |= {p.stem for p in d.glob("*.wav")}
        return sorted(stems)

    def wav_path(self, kind: str, segment: str) -> Path | None:
        d = self.dirs.get(kind)
        if d is None:
            return None
        p = d / f"{segment}.wav"
        return p if p.exists() else None

    def plot_data(self, kind: str, segment: str) -> dict | None:
        key = (kind, segment)
        with self.lock:
            if key in self.cache:
                return self.cache[key]
        p = self.wav_path(kind, segment)
        if p is None:
            return None
        tg_dir = self.textgrid_dirs.get(kind)
        tg = tg_dir / f"{segment}.TextGrid" if tg_dir else None
        data = compute_plot_data(p, tg, device=self.device)
        with self.lock:
            self.cache[key] = data
        return data

    def preload_all(self, workers: int = 4) -> None:
        jobs = [(k, s) for s in self.segments() for k in self.dirs]
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda ks: self.plot_data(*ks), jobs))
        log.info("preloaded %d plot datasets", len(self.cache))


def make_handler(svc: VizService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt, *args)

        def _json(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 — AB-test response logging
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if parts == ["ab_response"]:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    rec = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._json({"error": "invalid JSON"}, 400)
                svc.log_ab_response(rec)
                return self._json({"status": "ok"})
            return self._json({"error": "unknown route"}, 404)

        def do_GET(self):  # noqa: N802 (stdlib API)
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if parts == ["abtest"]:
                page = Path(__file__).parent / "static" / "abtest.html"
                body = page.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if not parts:  # the static front-end (reference: static/index.html)
                page = Path(__file__).parent / "static" / "index.html"
                body = page.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["kinds"]:
                return self._json(sorted(svc.dirs.keys()))
            if parts == ["segments"]:
                return self._json(svc.segments())
            if len(parts) == 3 and parts[0] == "audio":
                p = svc.wav_path(parts[1], parts[2])
                if p is None:
                    return self._json({"error": "not found"}, 404)
                data = p.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if len(parts) == 3 and parts[0] == "plot_data":
                data = svc.plot_data(parts[1], parts[2])
                if data is None:
                    return self._json({"error": "not found"}, 404)
                return self._json(data)
            return self._json({"error": "unknown route"}, 404)

    return Handler


def serve(svc: VizService, port: int = 8000, preload: bool = True) -> ThreadingHTTPServer:
    """Preload every plot (optional), then serve on a daemon thread.
    Returns the server: ``server_address`` gives the port (0 picks a free
    one), ``shutdown()`` and ``server_close()`` stop it."""
    if preload:
        svc.preload_all()
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    log.info("viz server on :%d", httpd.server_address[1])
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--natural")
    ap.add_argument("--synthetic")
    ap.add_argument("--improved")
    ap.add_argument("--raw")
    ap.add_argument("--textgrids")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--no-preload", action="store_true")
    ap.add_argument("--ab-log", help="JSONL path for AB-test responses")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dirs = {
        k: v
        for k, v in {
            "natural": args.natural,
            "synthetic": args.synthetic,
            "improved": args.improved,
            "raw": args.raw,
        }.items()
        if v
    }
    tg = {"natural": args.textgrids} if args.textgrids else None
    svc = VizService(dirs, tg, ab_log_path=args.ab_log, device=args.device)
    httpd = serve(svc, port=args.port, preload=not args.no_preload)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

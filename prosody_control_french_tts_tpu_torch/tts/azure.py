"""Azure Cognitive Services TTS over plain REST (stdlib ``urllib``).

The reference uses the ``azure.cognitiveservices.speech`` SDK
(Code/Preprocessing/get_synth.py:36-44, synthesize_ssml_voice.py:168-228);
this client speaks the same service's REST endpoint, so the port needs no
SDK. Behaviour:

- output format ``riff-44100hz-16bit-mono-pcm`` (the SDK default the
  pipeline stitches against);
- on HTTP 400, invalid SSML (the SDK's cancellation error 1007), one retry
  with the simplified plain-text document (synthesize_ssml_voice.py:217-228),
  then ``TTSError(code=1007)``;
- on 429 and 5xx, and on network failures or a malformed payload, up to
  ``max_retries`` attempts with a back-off of ``2 ** attempt`` s; any other
  HTTP status raises at once.

Constructing a backend makes no network call.
"""

from __future__ import annotations

import http.client
import struct
import time
import urllib.error
import urllib.request

import numpy as np

from ..utils.wavio import Audio
from .base import TTSError, simplify_ssml


class AzureBackend:
    sample_rate = 44100

    def __init__(
        self,
        api_key: str,
        region: str = "francecentral",
        voice: str = "fr-FR-HenriNeural",
        max_retries: int = 3,
        timeout_s: float = 30.0,
    ):
        self.api_key = api_key
        self.region = region
        self.voice = voice
        self.max_retries = max_retries
        self.timeout_s = timeout_s

    @property
    def _url(self) -> str:
        return f"https://{self.region}.tts.speech.microsoft.com/cognitiveservices/v1"

    def _post(self, ssml: str) -> bytes:
        req = urllib.request.Request(
            self._url,
            data=ssml.encode("utf-8"),
            headers={
                "Ocp-Apim-Subscription-Key": self.api_key,
                "Content-Type": "application/ssml+xml",
                "X-Microsoft-OutputFormat": "riff-44100hz-16bit-mono-pcm",
                "User-Agent": "prosody-control-french-tts-tpu",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def synthesize(self, ssml: str) -> Audio:
        last: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                return _decode_riff(self._post(ssml))
            except urllib.error.HTTPError as e:
                if e.code == 400:
                    # invalid SSML (SDK error 1007): the simplified document
                    try:
                        return _decode_riff(self._post(simplify_ssml(ssml, self.voice)))
                    except Exception as e2:  # noqa: BLE001 — reported as the 1007 failure
                        raise TTSError(f"Azure rejected SSML and fallback: {e2}", code=1007) from e2
                if e.code in (429, 500, 502, 503) and attempt + 1 < self.max_retries:
                    time.sleep(2.0**attempt)
                    last = e
                    continue
                raise TTSError(f"Azure HTTP {e.code}", code=e.code) from e
            except (OSError, http.client.HTTPException, TTSError) as e:
                # the network (URLError, timeouts, resets) or a malformed payload
                last = e
                if attempt + 1 < self.max_retries:
                    time.sleep(2.0**attempt)
        raise TTSError(f"Azure synthesis failed after retries: {last}")


def _decode_riff(raw: bytes) -> Audio:
    """The service's RIFF payload (PCM16 mono) → float32 samples in
    [-1, 1) at the payload's rate."""
    if raw[:4] != b"RIFF":
        raise TTSError("Azure returned non-RIFF payload")
    pos = 12
    data = None
    rate = 44100
    while pos + 8 <= len(raw):
        cid, size = raw[pos : pos + 4], struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            rate = struct.unpack("<I", raw[pos + 12 : pos + 16])[0]
        elif cid == b"data":
            data = raw[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)
    if data is None:
        raise TTSError("Azure RIFF payload missing data chunk")
    samples = np.frombuffer(data, dtype="<i2").astype(np.float32) * np.float32(1.0 / 32768.0)
    return Audio(samples, rate)

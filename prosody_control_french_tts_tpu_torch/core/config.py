"""Typed configuration tree, compatible with the reference config.yaml.

Port of the JAX package's ``core/config.py``: one dataclass tree with the
reference's keys and defaults, real ``${ENV_VAR}`` interpolation in every
string value, and the framework's extra keys (``tts_backend``, ``aligner``,
``pos_backend``). ``multiprocessing: true`` with more than one voice sends
``main()`` through ``core.batch_runner`` (one batched measure pass for
every voice, the counterpart of the reference's process pool). The Azure
backend's key file and region are fields, with :meth:`PipelineConfig.read_azure_key`.
Keys that nothing in the port reads (the JAX package's Whisper model and
device, the pool's ``num_processes``) stay in ``raw``, which
``used_config.yaml`` writes; ``ab_test`` (the A/B-test export's settings,
which the ``abtest`` command reads) is a field as well. ``load_config`` reads YAML and imports
PyYAML inside the function: only the command line needs it.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path

from ..prosody.adjust import ProsodySettings

_ENV = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def _interp(value):
    if isinstance(value, str):
        return _ENV.sub(lambda m: os.environ.get(m.group(1), m.group(0)), value)
    if isinstance(value, dict):
        return {k: _interp(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_interp(v) for v in value]
    return value


@dataclass
class SilenceSettings:
    """config.yaml ``silence``."""

    min_silence_len: int = 1000
    silence_thresh: float = -50.0
    keep_silence: int = 300


@dataclass
class PipelineConfig:
    base_dir: Path
    data_dir: str = "Data/voice"
    out_dir: str = "Out"
    azure_key_file: str = ""
    voice_names: list[str] = field(default_factory=list)
    azure_voice_name: str = "fr-FR-HenriNeural"
    azure_region: str = "francecentral"
    silence: SilenceSettings = field(default_factory=SilenceSettings)
    prosody: ProsodySettings = field(default_factory=ProsodySettings)
    steps_to_run: list[str] | None = None
    multiprocessing: bool = False
    # framework extensions (absent from reference configs → defaults)
    tts_backend: str = "azure"  # azure | fake
    aligner: str = "precomputed"  # precomputed | energy | ctc | whisper_jax
    pos_backend: str = "lexicon"  # lexicon | contextual
    ab_test: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    @property
    def data_path(self) -> Path:
        return self.base_dir / self.data_dir

    @property
    def out_path(self) -> Path:
        return self.base_dir / self.out_dir

    def read_azure_key(self) -> str:
        """The key in ``azure_key_file`` (relative to ``base_dir``), else
        the ``AZURE_API_KEY`` variable, else empty. An unset key file is not
        read: the JAX package resolves ``""`` to ``base_dir`` and fails to
        read that directory, so its default configuration does not build."""
        p = Path(self.azure_key_file)
        if not p.is_absolute():
            p = self.base_dir / p
        if self.azure_key_file and p.is_file():
            return p.read_text(encoding="utf-8").strip()
        return os.environ.get("AZURE_API_KEY", "")

    @classmethod
    def from_dict(cls, cfg: dict, base_dir: str | Path) -> "PipelineConfig":
        cfg = _interp(cfg)
        voices = cfg.get("voice_names") or []
        if isinstance(voices, str):
            voices = [voices]
        sil = cfg.get("silence", {}) or {}
        return cls(
            base_dir=Path(base_dir),
            data_dir=cfg.get("data_dir", "Data/voice"),
            out_dir=cfg.get("out_dir", "Out"),
            azure_key_file=cfg.get("azure_key_file", ""),
            voice_names=list(voices),
            azure_voice_name=cfg.get("azure_voice_name", "fr-FR-HenriNeural"),
            azure_region=cfg.get("azure_region", "francecentral"),
            silence=SilenceSettings(
                min_silence_len=sil.get("min_silence_len", 1000),
                silence_thresh=sil.get("silence_thresh", -50),
                keep_silence=sil.get("keep_silence", 300),
            ),
            prosody=ProsodySettings.from_config(cfg),
            steps_to_run=cfg.get("steps_to_run"),
            multiprocessing=bool(cfg.get("multiprocessing", False)),
            tts_backend=cfg.get("tts_backend", "azure"),
            aligner=cfg.get("aligner", "precomputed"),
            pos_backend=cfg.get("pos_backend", "lexicon"),
            ab_test=cfg.get("ab_test", {}) or {},
            raw=cfg,
        )


def load_config(path: str | Path) -> PipelineConfig:
    import yaml

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Missing config.yaml at {path}")
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    if not cfg:
        raise ValueError("Empty config.yaml")
    return PipelineConfig.from_dict(cfg, path.resolve().parent)

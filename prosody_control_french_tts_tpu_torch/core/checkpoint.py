"""Training-state checkpoints and pipeline-step resume markers.

The reference's recovery story: HF-Trainer step checkpoints for the LLMs
(keep the newest two, ``save_total_limit=2``), ``checkpoint_<step>_done.txt``
markers for the legacy pipeline's stages, and on-disk artifacts that let
``steps_to_run`` resume. Here:

- ``save_train_state`` / ``restore_train_state``: one directory
  ``step_{step:08d}`` a save, holding ``state.pt``, a ``torch.save`` of the
  state (``state_dict``s, optimizer state, plain Python numbers), with a
  keep-newest-N policy. The JAX package writes orbax trees under the same
  names and returns the same values; the files inside differ;
- ``StepMarkers``: the checkpoint-file contract used by ``legacy.Voc``
  and available to any pipeline.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def save_train_state(ckpt_dir: str | Path, step: int, state: dict, keep: int = 2) -> Path:
    """Write ``state`` (a dict of tensors, ``state_dict``s, optimizer states
    and plain numbers) as ``ckpt_dir/step_{step:08d}`` and delete all but the
    newest ``keep`` steps. Returns the step's directory."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    path.mkdir(exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path / STATE_FILE)
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    return steps[-1] if steps else None


def _onto(saved, template):
    """``saved`` moved onto the devices and dtypes of ``template``'s tensors,
    leaf by leaf where the structures match; a leaf with no counterpart in
    the template stays as saved."""
    if isinstance(template, torch.Tensor) and isinstance(saved, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict) and isinstance(saved, dict):
        return {k: _onto(v, template[k]) if k in template else v for k, v in saved.items()}
    if isinstance(template, (list, tuple)) and isinstance(saved, (list, tuple)) and len(template) == len(saved):
        return type(saved)(_onto(s, t) for s, t in zip(saved, template))
    return saved


def restore_train_state(ckpt_dir: str | Path, template: dict, step: int | None = None) -> tuple[dict, int]:
    """The newest step under ``ckpt_dir`` (or ``step``), restored onto the
    devices and dtypes of ``template``'s tensors. Returns (state, step);
    raises ``FileNotFoundError`` when there is none."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{step:08d}" if step is not None else latest_checkpoint(ckpt_dir)
    if path is None or not (path / STATE_FILE).exists():
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    saved = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    return _onto(saved, template), int(path.name.split("_")[1])


class StepMarkers:
    """checkpoint_<step>_done.txt contract (pipeline_class_legacy.py:545-562)."""

    def __init__(self, out_dir: str | Path, enabled: bool = True):
        self.out_dir = Path(out_dir)
        self.enabled = enabled
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def path(self, step: str) -> Path:
        return self.out_dir / f"checkpoint_{step}_done.txt"

    def done(self, step: str) -> bool:
        return self.enabled and self.path(step).exists()

    def mark(self, step: str) -> None:
        self.path(step).write_text("done", encoding="utf-8")

    def clear(self) -> None:
        for p in self.out_dir.glob("checkpoint_*_done.txt"):
            p.unlink()

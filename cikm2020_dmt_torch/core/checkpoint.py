"""Checkpoints with the reference's save and marker protocol (the port's
own format; the JAX package writes Orbax directories).

Reference protocol (run_dnn.py:258-261,379-388,409-429,447-449):

- a save every ``validate_step`` steps as ``{model_path}/model.ckpt-{step}``;
- a ``step-{step}.model.DONE`` marker beside it, which an evaluator polls;
- every checkpoint kept;
- the resume step parsed from the checkpoint's name.

Here ``model.ckpt-{step}`` is a directory holding one ``torch.save`` file
of the whole train state (``params``, ``model_state``, ``opt``,
``lazy_opt``, ``step``, ``lazy_overflow``; a state saved before the model
state existed restores without it, and eval reads it as ``{}``).  The file is written under a temporary name, flushed
to disk and renamed into place, and the marker is written last, so a
poller never sees a half-written checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_CKPT_RE = re.compile(r"model\.ckpt-(\d+)$")
STATE_FILE = "state.pt"


def save_file(obj: Any, final: str) -> None:
    """``torch.save`` of ``obj`` to ``final`` under a temporary name,
    flushed to disk and renamed into place: a reader sees the old file or
    the whole new one."""
    tmp = f"{final}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def step_from_name(name: str) -> Optional[int]:
    m = _CKPT_RE.search(name)
    return int(m.group(1)) if m else None


class CheckpointManager:
    """Saves, restores and finds the checkpoints under ``model_path``,
    which the first save creates."""

    def __init__(self, model_path: str):
        self.model_path = os.path.abspath(model_path)

    # -- paths ----------------------------------------------------------
    def ckpt_dir(self, step: int) -> str:
        return os.path.join(self.model_path, f"model.ckpt-{step}")

    def marker_path(self, step: int) -> str:
        return os.path.join(self.model_path, f"step-{step}.model.DONE")

    # -- save / restore -------------------------------------------------
    def save(self, step: int, state: Any) -> str:
        """Writes ``state`` (nested dicts of tensors, on any device) as
        ``model.ckpt-{step}``, then its DONE marker.  A save of a step that
        exists replaces it; its marker is removed first, so the step reads
        as incomplete until the new file is in place."""
        path = self.write(step, state)
        self.mark_done(step)
        return path

    def write(self, step: int, state: Any) -> str:
        """``save`` without the marker: removes the step's marker, then
        writes the state file into place."""
        path = self.ckpt_dir(step)
        os.makedirs(path, exist_ok=True)
        marker = self.marker_path(step)
        if os.path.exists(marker):
            os.remove(marker)
        save_file(state, os.path.join(path, STATE_FILE))
        return path

    def mark_done(self, step: int) -> None:
        """The DONE marker of a step whose state file is in place."""
        with open(self.marker_path(step), "w") as f:
            f.write(str(step))

    def restore(self, step: int, device="cpu") -> Any:
        """The state saved at ``step``, its tensors on ``device``."""
        return torch.load(os.path.join(self.ckpt_dir(step), STATE_FILE),
                          map_location=device, weights_only=True)

    def has_step(self, step: int) -> bool:
        return os.path.isdir(self.ckpt_dir(step)) and \
            os.path.exists(self.marker_path(step))

    # -- discovery (reference get_ckpt_from_fs, run_dnn.py:409-429) -----
    def all_steps(self) -> list[int]:
        steps = []
        if not os.path.isdir(self.model_path):
            return steps
        for name in os.listdir(self.model_path):
            s = step_from_name(name)
            if s is not None and os.path.isdir(
                    os.path.join(self.model_path, name)):
                steps.append(s)
        return sorted(steps)

    def newest_step_after(self, step: int) -> Optional[int]:
        """Newest *completed* (DONE-marked) step greater than ``step``."""
        done = [s for s in self.all_steps()
                if s > step and os.path.exists(self.marker_path(s))]
        return max(done) if done else None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

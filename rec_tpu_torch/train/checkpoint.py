"""Reading rec_tpu's checkpoints (port of the read side of
rec_tpu/train/checkpoint.py).

rec_tpu saves ``ckpt_<step>.msgpack`` files with flax's msgpack
serialization and a ``model_config.json`` beside them.  The port restores
``params`` and ``ema_params`` of the newest checkpoint as trees of numpy
arrays (``models/convert.py`` loads them into a model), so a model trained
with rec_tpu is served on the card.  Nothing here writes to the directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

from .msgpack import unpackb

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")
_MODEL_CONFIG = "model_config.json"


def load_model_config(directory: str) -> Optional[dict]:
    """The persisted {"kind", "cfg"} dict, or None."""
    path = os.path.join(directory, _MODEL_CONFIG)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def reconcile_model_config(directory: str, kind: str, cfg, log=None):
    """Return ``cfg`` corrected to the config the checkpoint was trained
    with: where ``directory`` records a config of the same ``kind`` that
    differs, the trained one wins and a warning names every overridden
    field (a checkpoint restores silently onto a model of another config
    with the same parameter tree).  JSON lists become tuples where the
    dataclass field is a tuple."""
    saved = load_model_config(directory)
    if saved is None or saved.get("kind") != kind:
        return cfg
    current = dataclasses.asdict(cfg)
    overrides = {}
    for f in dataclasses.fields(cfg):
        if f.name not in saved["cfg"]:
            continue
        v = saved["cfg"][f.name]
        if isinstance(getattr(cfg, f.name), tuple) and isinstance(v, list):
            v = tuple(v)
        if current.get(f.name) != v:
            overrides[f.name] = v
    if overrides:
        msg = (f"checkpoint {directory} was trained with {overrides} — "
               f"overriding the requested model config to match")
        (log.warning if log else print)(msg)
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


class CheckpointManager:
    """Read-only view of a rec_tpu checkpoint directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_CKPT_RE.match, os.listdir(self.directory)) if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_params(self) -> Optional[dict]:
        """``{"step", "params", "ema_params"}`` of the newest checkpoint
        (numpy trees), or None if there is none."""
        step = self.latest_step
        if step is None:
            return None
        path = os.path.join(self.directory, f"ckpt_{step}.msgpack")
        with open(path, "rb") as f:
            raw = unpackb(f.read())
        return {"step": int(raw["step"]), "params": raw["params"],
                "ema_params": raw["ema_params"]}

"""Checkpoints in rec_tpu's format (port of rec_tpu/train/checkpoint.py).

``ckpt_<step>.msgpack`` holds the whole train state as flax's msgpack
serialization of rec_tpu's ``TrainState``: step, params, opt_state (optax's
layout), ema_params and beta, the parameter trees in the flax model's
``{"params": ...}`` form (``models/convert.py`` for the lossless model,
``models/lossy/convert.py`` for the lossy ones); the newest 3 are kept and
every write is atomic (a ``.tmp`` file, then ``os.replace``).  A
``model_config.json`` beside them records the model family and config.
Either package restores the other's files: the port resumes training from
a rec_tpu checkpoint and rec_tpu from the port's, and the serving and
evaluation CLIs load the weights of either.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import numpy as np

from ..models import convert as lossless_convert
from .msgpack import packb, unpackb
from .state import TrainState, copy_into

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")
_MODEL_CONFIG = "model_config.json"


def save_model_config(directory: str, kind: str, cfg) -> None:
    """Write the model family and config (``{"kind", "cfg"}``) beside the
    checkpoints, so an evaluation restores them onto the trained
    architecture."""
    os.makedirs(directory, exist_ok=True)
    cfg_dict = (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
                else dict(cfg))
    with open(os.path.join(directory, _MODEL_CONFIG), "w") as f:
        json.dump({"kind": kind, "cfg": cfg_dict}, f, indent=2)


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
    """Save, resume and read checkpoints of a train state in ``directory``
    (created at the first save).  ``convert`` maps the model's tensors to
    and from the flax tree (``to_numpy_tree``/``from_numpy_tree``): the
    lossless model's converter by default, ``models.lossy.convert`` for a
    lossy VAE."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 convert=lossless_convert):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.convert = convert

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_CKPT_RE.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.msgpack")

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _read(self) -> Optional[dict]:
        step = self.latest_step
        if step is None:
            return None
        with open(self._path(step), "rb") as f:
            return unpackb(f.read())

    def save(self, state: TrainState) -> str:
        """Write ``ckpt_<state.step>.msgpack`` (rec_tpu's ``TrainState``
        layout; reads the tensors back from the device) and drop all but
        the newest ``max_to_keep``.  Returns the path."""
        to_tree = self.convert.to_numpy_tree
        tree = {"step": np.asarray(state.step, np.int32),
                "params": to_tree(state.params),
                "opt_state": state.opt_state.layout(to_tree),
                "ema_params": to_tree(state.ema_params),
                "beta": np.asarray(float(state.beta), np.float32)}
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(state.step)
        with open(path + ".tmp", "wb") as f:
            f.write(packb(tree))
        os.replace(path + ".tmp", path)
        for old in self._steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, template: TrainState) -> Optional[TrainState]:
        """The newest checkpoint copied into ``template``'s tensors (the
        model's parameters, the moments and EMA shadows, on their device),
        or None when there is none.  Raises if the checkpoint's tensors or
        optimizer layout do not match the template's."""
        raw = self._read()
        if raw is None:
            return None
        from_tree = self.convert.from_numpy_tree
        copy_into(template.params, from_tree(raw["params"]))
        copy_into(template.ema_params, from_tree(raw["ema_params"]))
        opt_state = template.opt_state.load_layout(raw["opt_state"],
                                                   from_tree)
        beta = template.beta.new_tensor(float(raw["beta"]))
        return template._replace(step=int(raw["step"]), opt_state=opt_state,
                                 beta=beta)

    def restore_params(self) -> Optional[dict]:
        """``{"step", "params", "ema_params"}`` of the newest checkpoint
        (numpy trees), or None if there is none; the optimizer's layout
        does not matter here."""
        raw = self._read()
        if raw is None:
            return None
        return {"step": int(raw["step"]), "params": raw["params"],
                "ema_params": raw["ema_params"]}

"""Checkpoints of the training state (``detjax/train/checkpoint.py``).

A checkpoint of step ``s`` is the directory ``<directory>/<s>/`` with two
items, as detjax's Orbax Composite layout has:

- ``state.pt``: ``step``, the model's ``state_dict`` (parameters and the
  BatchNorm running statistics, detjax's ``params`` and ``batch_stats``),
  the optimizer's ``state_dict`` (``OptaxOptimizer``'s ``count``, ``mu``,
  ``nu`` and each group's rate, detjax's ``opt_state``) and the EMA shadow
  when there is one; written with ``torch.save`` and read back with
  ``weights_only=True``;
- ``host.json``: the host controller's state (the plateau controller and
  the loss window), when the writer passed one. Consumers that want only
  the device state never read it.

Each save is written under a temporary name in ``<directory>`` and
published by one ``os.rename``, so a reader sees a whole checkpoint or
none; past ``max_to_keep`` the oldest are deleted after the new one is
published. Resume is bit-exact: same parameters, statistics, moments,
step and controller state, and ``fit`` seeks the data stream to the same
global batch.

The port's :class:`~detjax_torch.train.step.TrainState` is updated in
place, where detjax's async save reads immutable arrays. So a save first
copies every tensor into host memory, synchronously, and only the file
write runs on a background thread, which :meth:`Checkpointer.wait` joins:
steps taken after ``save`` returns cannot reach the checkpoint.

detjax also reads its legacy Orbax layout (one ``default`` item); the
port has no older format, so there is no counterpart.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import torch

from detjax_torch.train.step import TrainState

STATE_FILE = "state.pt"
HOST_FILE = "host.json"


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor copied into host memory (nested dicts and
    lists kept). A copy, also of a CPU tensor, so that later in-place
    updates of the live state do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state: TrainState) -> Dict[str, Any]:
    snap = {"step": int(state.step),
            "model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict())}
    if state.ema is not None:
        snap["ema"] = _to_host(state.ema)
    return snap


def _check_tensors(live: Dict[str, torch.Tensor],
                   saved: Dict[str, torch.Tensor], what: str) -> None:
    """Raise unless ``saved`` has exactly ``live``'s keys and shapes."""
    missing = sorted(set(live) - set(saved))
    unexpected = sorted(set(saved) - set(live))
    if missing or unexpected:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:5]} and has "
                       f"unexpected {unexpected[:5]}")
    for k, t in live.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k} has shape "
                             f"{tuple(saved[k].shape)} in the checkpoint "
                             f"and {tuple(t.shape)} in the state")


def _check_optimizer(optimizer: torch.optim.Optimizer,
                     saved: Dict[str, Any]) -> None:
    """Raise unless the saved optimizer state has the live optimizer's
    groups, rule and hyperparameters (the rate aside, which the plateau
    controller moves) and moment shapes; ``load_state_dict`` itself checks
    only the counts."""
    groups, sgroups = optimizer.param_groups, saved["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"])
                                              for g in sgroups]:
        raise ValueError("the checkpoint's optimizer has other parameter "
                         "groups than the live optimizer")
    for g, sg in zip(groups, sgroups):
        for key in set(g) - {"params", "lr"}:
            if sg.get(key) != g[key]:
                raise ValueError(f"optimizer {key}={sg.get(key)!r} in the "
                                 f"checkpoint, {g[key]!r} in the state")
        for p, idx in zip(g["params"], sg["params"]):
            for name, t in saved["state"].get(idx, {}).items():
                if isinstance(t, torch.Tensor) and t.shape != p.shape:
                    raise ValueError(
                        f"optimizer state {name!r} of parameter {idx} has "
                        f"shape {tuple(t.shape)} in the checkpoint and the "
                        f"parameter {tuple(p.shape)}")


class Checkpointer:
    """Save and restore a :class:`TrainState` by step."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        """The newest published step, or None. Waits for a save in flight."""
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, wait: bool = False,
             host: Optional[dict] = None) -> None:
        """Checkpoint ``state`` as of this call. ``host``: a flat dict of
        host-side scalars (e.g. the plateau controller's), saved as the
        separate JSON item. The tensors are copied to host memory before
        this returns; the files are written on a background thread unless
        ``wait``. A save of a step that is already published raises, as
        Orbax does."""
        self.wait()
        snap = _snapshot(state)
        step = snap["step"]
        if os.path.exists(os.path.join(self.directory, str(step))):
            raise FileExistsError(
                f"a checkpoint of step {step} exists in {self.directory}")
        host_item = None if not host else {
            k: (v.item() if hasattr(v, "item") else v)
            for k, v in host.items()}

        def write():
            try:
                tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-",
                                       dir=self.directory)
                torch.save(snap, os.path.join(tmp, STATE_FILE))
                if host_item is not None:
                    with open(os.path.join(tmp, HOST_FILE), "w") as f:
                        json.dump(host_item, f)
                os.rename(tmp, os.path.join(self.directory, str(step)))
                for old in self._steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
            except BaseException as exc:  # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()
        if wait:
            self.wait()

    def restore(self, state: TrainState, step: Optional[int] = None,
                host_template: Optional[dict] = None):
        """Load step ``step`` (default: the latest) into the live ``state``
        on its device, in place, and return it; with ``host_template`` (a
        dict shaped like ``save``'s ``host``) return ``(state, host)``,
        ``host`` falling back to the template's values where the
        checkpoint has no host item. A missing or unexpected key or a shape
        that differs raises, and is never swallowed: restoring another
        preset's checkpoint must fail. A state with EMA needs a checkpoint
        with EMA; a checkpoint's EMA is ignored by a state without."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, str(step))
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location="cpu", weights_only=True)
        # every check before the first write into the live state
        _check_tensors(state.model.state_dict(), saved["model"], "model")
        _check_optimizer(state.optimizer, saved["optimizer"])
        if state.ema is not None:
            if "ema" not in saved:
                raise KeyError(
                    f"the state keeps an EMA shadow (train.ema_decay > 0) "
                    f"and the checkpoint of step {step} has none; start EMA "
                    f"from a fresh state")
            _check_tensors(state.ema, saved["ema"], "ema")
        state.model.load_state_dict(saved["model"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        if state.ema is not None:
            with torch.no_grad():
                for name, t in state.ema.items():
                    t.copy_(saved["ema"][name])
        state.step = int(saved["step"])
        if host_template is None:
            return state
        host = dict(host_template)
        host_path = os.path.join(path, HOST_FILE)
        if os.path.exists(host_path):
            with open(host_path) as f:
                host.update(json.load(f))
        return state, host

    def wait(self) -> None:
        """Join the save in flight, re-raising its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

"""Metrics logging (``detjax/utils/logging.py``).

Every logged step's metrics go to ``<log_dir>/metrics.jsonl``, one JSON
object a line, in detjax's records (``kind``, ``step``, ``time`` and the
metrics), with a compact stdout line every ``print_every`` steps; eval
results are ``kind="eval"`` records. With ``tensorboard=True`` the scalars
also go to ``<log_dir>/tb`` through ``torch.utils.tensorboard`` where that
imports; the JSONL stays the record either way.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np


def _to_py(v: Any) -> Any:
    """A tensor or numpy scalar as a Python number, an array as a list,
    for JSON."""
    if isinstance(v, np.ndarray) and v.ndim:
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


class MetricsLogger:
    """JSONL metrics writer with periodic stdout summaries."""

    def __init__(self, log_dir: Optional[str] = None, print_every: int = 50,
                 stream=None, tensorboard: bool = False):
        self.print_every = print_every
        self.stream = stream if stream is not None else sys.stdout
        self._fh = None
        self._tb = None
        if tensorboard and not log_dir:
            print("[logging] tensorboard requested but no log_dir set; "
                  "nothing will be written", file=self.stream)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                            buffering=1)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    print("[logging] tensorboard requested but tf.summary "
                          "unavailable; JSONL only", file=self.stream)
                else:
                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], kind: str = "train"):
        rec = {"kind": kind, "step": int(step),
               "time": round(time.time() - self._t0, 3)}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(f"{kind}/{k}", v, int(step))
        if kind != "train" or (self.print_every
                               and step % self.print_every == 0):
            keys = [k for k in rec if k not in ("kind", "step", "time")]
            body = " ".join(
                f"{k}={rec[k]:.4f}" if isinstance(rec[k], float)
                else f"{k}={rec[k]}" for k in keys)
            print(f"[{kind}] step={step} {body}", file=self.stream)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

"""Cells cut to a size the CPU runs in seconds, for the tests: the same
files, with the canvas, the FPN and head widths, the batch and the mix
shrunk."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

SMALL = {"hw": 128, "ch": 32, "train_batch": 2, "serve_batch": 2}


def small_run(cell_name: str, seed: int = 7, seconds: float = 1.0,
              trace: bool = False) -> harness.Run:
    """The cell ``cell_name``, cut small."""
    cell, config, traffic = harness.load_cell(cell_name)
    conf, tr = copy.deepcopy(config), copy.deepcopy(traffic)
    hw, ch = SMALL["hw"], SMALL["ch"]
    conf["overrides"] = dict(conf["overrides"], **{
        "model.image_size": (hw, hw), "model.fpn_channels": ch,
        "model.head_channels": ch})
    conf["model"].update(image_size=[hw, hw], fpn_channels=ch,
                         head_channels=ch)
    if tr["driver"] == "train":
        tr.update(batch=SMALL["train_batch"], pool_batches=4,
                  warmup_steps=1, trace_steps=2)
    else:
        tr.update(batch=SMALL["serve_batch"], pool=8, warmup_s=0.5,
                  trace_s=0.3, sample=4, senders=8, clients=4,
                  max_img_s=200)
        if "rate_img_s" in tr:
            tr["rate_img_s"] = 8.0
    return harness.Run(cell, conf, tr, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter())

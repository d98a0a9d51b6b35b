"""The reference agrees with the program on the CPU, fp32, at a small
size, with the benchmark's own weights: forward, one training step, the
detections. The program runs here through its plain twins."""

import copy

import numpy as np
import pytest
import torch

import detjax_torch
from benchmark import harness, weights
from benchmark.drivers.train import make_pool
from benchmark.reference import detection as D
from benchmark.reference import model as R
from benchmark.reference import serve as RS
from benchmark.reference import train as T
from benchmark.tests.small import small_run


@pytest.fixture(scope="module")
def setup():
    r = small_run("r50_1024-train", seed=11)
    conf = copy.deepcopy(r.config)
    conf["overrides"]["model.dtype"] = "float32"
    conf["model"]["dtype"] = "float32"
    cfg = harness.program_config(conf, **{"train.seed": 11})
    images, boxes, labels = make_pool(r, conf["model"], 2)
    ref = R.build(conf["model"], "cpu")
    w0 = {k: v.clone() for k, v in weights.make(ref, 11, images[0]).items()}
    return conf, cfg, ref, w0, images, boxes, labels


def test_the_state_dict_loads_into_both(setup):
    conf, cfg, ref, w0, *_ = setup
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(w0, strict=True)
    assert set(model.state_dict()) == set(w0)


def test_forward_agrees(setup):
    conf, cfg, ref, w0, images, *_ = setup
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(w0)
    ref.load_state_dict(w0)
    x = D.normalize(images[0])
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last))
        want = ref(x)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    # desaturated: logits spread around the prior, deltas small
    assert 1.0 < float(want[0].std()) < 4.0
    assert float(want[1].std()) < 1.0


def test_one_training_step_agrees(setup):
    conf, cfg, ref, w0, images, boxes, labels = setup
    state = detjax_torch.make_train_state(cfg, seed=0, device="cpu")
    state.model.load_state_dict(w0)
    _, m = detjax_torch.train_step(state, {"images": images[0],
                                           "gt_boxes": boxes[0],
                                           "gt_labels": labels[0]})
    named = dict(state.model.named_parameters())
    grad = T.leaf_norms({n: state.optimizer.state[p]["mu"] / 0.1
                         for n, p in named.items()})
    change = T.leaf_norms({n: p.detach() - w0[n] for n, p in named.items()})
    ref.load_state_dict(w0)
    want = T.run_steps(ref, [(images[0], boxes[0], labels[0])],
                       [D.flip_mask(11, 0, 2)], D.anchors(
                           (128, 128), range(3, 8),
                           conf["model"]["anchor_scales"],
                           conf["model"]["anchor_ratios"], 4.0, "cpu"),
                       conf["train"], conf["model"]["box_std"])
    gaps = T.compare({"losses": [float(m["loss"])], "grad": grad,
                      "change": change}, want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 1e-3


def test_detections_agree(setup):
    conf, cfg, ref, w0, images, *_ = setup
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(w0)
    ref.load_state_dict(w0)
    dets = detjax_torch.detect_u8(model, images[0], cfg)
    served = [[(dets.boxes[i].numpy(), dets.scores[i].numpy(),
                dets.labels[i].numpy(), int(dets.num_valid[i]))]
              for i in range(2)]
    gaps = RS.compare(ref, conf, images[0], served)
    assert gaps["logit_gap"] < 1e-3 and gaps["cover_gap"] < 1e-3
    assert gaps["box_gap"] < 1e-4
    mine = RS.detect(ref, conf, images[0])
    assert mine[0][3] == int(dets.num_valid[0])
    np.testing.assert_array_equal(mine[0][2], dets.labels[0].numpy())

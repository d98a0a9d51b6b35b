"""The SSD family (preset ``ssd_512``, benchmark config 2) in the port
against detjax's, on the CPU: R18 with FPN width 32 on 128-px canvases
(and 64 px for the CLI), the preset's own anchors (two absolute sizes a
level x ratios (1, 2, 0.5): 6 a cell), fp32, detjax's weights carried by
the port's ``from_jax``, inputs from a numpy seed. The bars are those of
``tests/test_torch_port_model.py`` (forward), ``test_torch_port_detect.py``
(keep-sets) and ``test_torch_port_train.py`` (one step)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax import export as jexport
from detjax import modeling as jmodeling
from detjax import quant as jquant
from detjax.config import get_config as j_get_config
from detjax.data import SyntheticDetectionDataset
from detjax.data.pipeline import device_augment as j_device_augment
from detjax.data.transforms import pad_annotations
from detjax.models.detector import build_detector as j_build_detector
from detjax.ops import losses as jlosses
from detjax.ops.anchors import anchors_for_shape as j_anchors_for_shape
from detjax.utils import torch_import as j_torch_import

import detjax_torch
from detjax_torch import export as texport
from detjax_torch import quant as tquant
from detjax_torch.data.pipeline import normalize_u8
from detjax_torch.models.detector import Detector
from detjax_torch.train import step as tstep
from detjax_torch.utils import torch_import as t_torch_import
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (128, 128)
_OVR = {"model.backbone_depth": 18, "model.image_size": HW,
        "model.num_classes": 6, "model.dtype": "float32",
        "model.fpn_channels": 32, "eval.pre_nms_top_k": 300,
        "eval.max_detections": 60, "train.batch_size": 2,
        "train.max_gt": 5}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def pair():
    """detjax's SSD variables and the port's model on the same weights.
    The predictors read the FPN's outputs directly (std near 70 at this
    init), so both are scaled by 0.1 and the class biases drawn around the
    prior: logits with a std near 1.4, a tenth of the scores above the
    0.05 floor and none saturating the fp32 sigmoid."""
    rng = np.random.default_rng(11)
    jcfg = j_get_config("ssd_512", **_OVR)
    tcfg = detjax_torch.get_config("ssd_512", **_OVR)
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(1))
    sd = dict(j_torch_import.export_full_detector(
        variables["params"], variables["batch_stats"], depth=18,
        family="ssd"))
    for lvl in range(3, 8):
        w, b = f"ssdHead.cls_p{lvl}.weight", f"ssdHead.cls_p{lvl}.bias"
        sd[w] = (sd[w] * 0.1).astype(np.float32)
        sd[b] = (sd[b] + rng.normal(0, 1.2, sd[b].shape)).astype(np.float32)
        r = f"ssdHead.box_p{lvl}.weight"
        sd[r] = (sd[r] * 0.1).astype(np.float32)
    variables = _np_tree(j_torch_import.import_detector_into_variables(
        variables, sd, depth=18, family="ssd"))
    model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax(variables["params"],
                                   variables["batch_stats"], tcfg.model),
                          strict=True)
    canvases = rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, model=model,
                canvases=canvases, sd=sd)


def test_ssd_512_preset_shapes():
    """The full preset: R50, P3-P7, 6 anchors a cell, A = 32,736; one
    (cls, box) 3x3 pair a level with A*K and A*4 outputs, the lineage's
    ``ssdHead.*`` keys, detjax's initialisers."""
    cfg = detjax_torch.get_config("ssd_512")
    assert cfg.model.num_anchors_per_cell == 6
    anchors = detjax_torch.ops.anchors.anchors_for_shape(
        cfg.model.image_size, detjax_torch.modeling.anchor_config(cfg))
    assert anchors.shape == (32736, 4)
    jcfg = j_get_config("ssd_512")
    np.testing.assert_array_equal(anchors, j_anchors_for_shape(
        jcfg.model.image_size, jmodeling.anchor_config(jcfg)))
    with torch.device("meta"):
        model = Detector(cfg.model)
    cls_convs, box_convs = model.output_convs()
    assert [c.out_channels for c in cls_convs] == [480] * 5
    assert [c.out_channels for c in box_convs] == [24] * 5
    assert not hasattr(model, "classificationModel")
    keys = {k.rsplit(".", 1)[0] for k in model.state_dict()
            if k.startswith(("ssdHead", "fpn"))}
    want = j_torch_import._head_key_map("ssd", 4, 3, 7)
    assert keys == set(want)
    small = detjax_torch.build_model(
        detjax_torch.get_config("ssd_512", **_OVR), seed=3, device="cpu")
    for conv in small.output_convs()[0]:
        assert torch.allclose(conv.bias, torch.full_like(conv.bias,
                                                         -np.log(99.0)))
        assert 0.005 < float(conv.weight.std()) < 0.015
    for conv in small.output_convs()[1]:
        assert not conv.bias.any()


def test_ssd_from_jax_equals_export_full_detector(pair):
    """The port's ``from_jax`` equals detjax's ``export_full_detector``
    key for key and value for value, and the port's importer takes that
    state dict back into detjax's layout as detjax's does."""
    variables, tcfg = pair["variables"], pair["tcfg"]
    sd = from_jax(variables["params"], variables["batch_stats"], tcfg.model)
    ref = j_torch_import.export_full_detector(
        variables["params"], variables["batch_stats"], depth=18,
        family="ssd")
    assert sorted(sd) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    fresh = detjax_torch.build_model(tcfg, seed=9, device="cpu")
    report = t_torch_import.import_full_detector(fresh, dict(ref))
    assert not report["missing"] and not report["unused"]
    for key, t in fresh.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[key], err_msg=key)
    back = t_torch_import.import_detector_into_variables(
        {k: torch.zeros_like(v) for k, v in fresh.state_dict().items()},
        ref, depth=18, family="ssd")
    assert all(torch.equal(back[k], v) for k, v in fresh.state_dict().items())


def test_ssd_forward_matches_detjax(pair):
    """Logits and deltas at fp32 within atol/rtol 5e-4 (the bar of
    test_torch_port_model.py's forward test)."""
    x = np.random.default_rng(0).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    j_cls, j_box = jax.jit(j_build_detector(pair["jcfg"].model).apply)(
        pair["variables"], jnp.asarray(x))
    with torch.no_grad():
        t_cls, t_box = pair["model"](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_cls.shape == j_cls.shape == (2, 2046, 6)
    assert t_box.shape == j_box.shape == (2, 2046, 4)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(t_box.numpy(), np.asarray(j_box), atol=5e-4,
                               rtol=5e-4)


def _assert_detections_match(got, want):
    """Identical keep-sets (labels and order), scores within atol 2e-5,
    boxes within atol 5e-3 (the bars of test_torch_port_detect.py)."""
    want = jax.tree.map(np.asarray, want)
    assert want.num_valid.min() > 10, "too few detections to be a test"
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                               atol=5e-3)


def test_ssd_detect_u8_matches_detjax(pair):
    want = jmodeling.detect_u8(pair["variables"], pair["canvases"],
                               pair["jcfg"])
    got = detjax_torch.detect_u8(pair["model"], pair["canvases"],
                                 pair["tcfg"])
    _assert_detections_match(got, want)


def _batch(seed=0, b=2, max_gt=5):
    ds = SyntheticDetectionDataset(b, HW, 6, max_objects=4, seed=seed,
                                   size_range=(0.3, 0.6))
    recs = [ds[i] for i in range(b)]
    pads = [pad_annotations(r["boxes"], r["labels"], max_gt) for r in recs]
    return {"images": np.stack([r["image"] for r in recs]),
            "gt_boxes": np.stack([p[0] for p in pads]),
            "gt_labels": np.stack([p[1] for p in pads])}


def test_ssd_one_step_gradients_match_detjax(pair, monkeypatch):
    """detjax's loss and gradient at step 0 (its loss_fn,
    train/step.py:136-165, with the flip mask it draws) against the port's
    ``compute_gradients`` on the same weights and batch: the loss within
    1e-5 relative, every gradient within 2e-3 relative plus 1e-4 of the
    tensor's largest (test_torch_port_train.py's bars); the matching
    finds positives at the SSD anchors."""
    jcfg, tcfg, variables = pair["jcfg"], pair["tcfg"], pair["variables"]
    batch = _batch()
    module = j_build_detector(jcfg.model)
    anchors = jnp.asarray(j_anchors_for_shape(HW,
                                              jmodeling.anchor_config(jcfg)))
    t = jcfg.train
    key = jax.random.fold_in(jax.random.PRNGKey(t.seed), 0)
    flip = np.array(jax.random.bernoulli(key, jcfg.data.hflip_prob, (2,)))
    monkeypatch.setattr(tstep, "flip_mask",
                        lambda cfg, step, b: torch.from_numpy(flip))

    def loss_fn(params):
        images, gt_boxes = j_device_augment.__wrapped__(
            jnp.asarray(batch["images"]), jnp.asarray(batch["gt_boxes"]),
            key, hflip_prob=jcfg.data.hflip_prob, mean=jcfg.data.mean,
            std=jcfg.data.std)
        cls, box = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                images, train=True)
        out = jlosses.detection_loss(cls, box, anchors, gt_boxes,
                                     jnp.asarray(batch["gt_labels"]))
        return out.cls_loss + out.reg_loss, out.metrics["num_pos"]

    (loss, num_pos), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    assert float(num_pos) > 0
    want = from_jax(_np_tree(grads), variables["batch_stats"], tcfg.model)
    state = detjax_torch.make_train_state(tcfg, seed=5, device="cpu")
    state.model.load_state_dict(pair["model"].state_dict(), strict=True)
    got_loss, metrics = tstep.compute_gradients(state, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert float(metrics["num_pos"]) == float(num_pos)
    named = dict(state.model.named_parameters())
    assert sum(n.startswith("ssdHead.") for n in named) == 20
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


@pytest.fixture(scope="module")
def int8(pair):
    """detjax's qtree and the port's, on the same weights and the same
    activation scales (detjax's calibration)."""
    x = normalize_u8(torch.from_numpy(pair["canvases"]), pair["tcfg"].data.mean,
                     pair["tcfg"].data.std)
    scales = jquant.calibrate(pair["variables"], pair["jcfg"],
                              jnp.asarray(x.numpy()))
    jtree = jquant.quantize(pair["variables"], pair["jcfg"], scales)
    ttree = tquant.quantize(pair["model"], pair["tcfg"], scales)
    return dict(x=x, scales=scales, jtree=jtree, ttree=ttree)


def test_ssd_qtree_bit_equal_to_detjax(pair, int8):
    """Every int8 weight, per-channel scale, folded bias and the stem's
    bf16 weight bit-equal, key for key, with the ten per-level predictor
    sites; the port's calibration names the same sites."""
    jtree, ttree = int8["jtree"], int8["ttree"]
    assert set(ttree["weights"]) == set(jtree["weights"])
    assert {p for p in ttree["weights"] if p.startswith("head/")} == {
        f"head/{k}_p{lvl}" for k in ("cls", "box") for lvl in range(3, 8)}
    for path, node in jtree["weights"].items():
        got = ttree["weights"][path]
        assert set(got) == set(node), path
        for key, want in node.items():
            want = np.asarray(want)
            if key == "w16":
                np.testing.assert_array_equal(
                    got[key].view(torch.int16).numpy(),
                    want.view(np.uint16).view(np.int16), err_msg=path)
            else:
                assert got[key].numpy().dtype == want.dtype, (path, key)
                np.testing.assert_array_equal(got[key].numpy(), want,
                                              err_msg=f"{path}/{key}")
    for site, want in jtree["act_scales"].items():
        assert ttree["act_scales"][site].item() == float(want), site
    port_sites = tquant.calibrate(pair["model"], pair["tcfg"], int8["x"])
    assert set(port_sites) == set(int8["scales"])


def test_ssd_detect_int8_matches_detjax(pair, int8):
    """``detect_int8`` on the port's qtree keeps the detections of
    detjax's jitted int8 engine on its own (bit-equal) qtree, compiled
    without excess precision (test_torch_port_quant.py's reason): the
    detect bars."""
    jtree, x = int8["jtree"], jnp.asarray(int8["x"].numpy())
    run = jax.jit(jquant._detect_int8_fn(pair["jcfg"])).lower(
        jtree, x).compile(
        compiler_options={"xla_allow_excess_precision": False})
    got = tquant.detect_int8(int8["ttree"], int8["x"], pair["tcfg"])
    _assert_detections_match(got, run(jtree, x))


def test_ssd_u8_program_matches_live_engine_and_detjax(pair, tmp_path):
    """An SSD detect program with uint8 input, saved and reloaded, equals
    ``detect_u8`` bit for bit, and detjax's u8 artifact on the same
    weights within the detect bars. (Through the int8 engine a uint8
    program would not be a fair comparison: XLA and ATen round the
    normalization's division differently by an ulp, within
    test_torch_port_detect.py's 1e-6 bar, and a flipped int8 rounding
    moves whole detections.)"""
    tcfg, canvases = pair["tcfg"], pair["canvases"]
    path = str(tmp_path / "ssd_u8.pt2")
    texport.save_detect(path, pair["model"], tcfg, batch_size=2,
                        input_format="u8")
    got = texport.load_detect(path)(canvases)
    live = detjax_torch.detect_u8(pair["model"], canvases, tcfg)
    for a, b in zip(got, live):
        assert torch.equal(a, b)
    exp = jexport.export_detect(pair["variables"], pair["jcfg"],
                                batch_size=2, input_format="u8")
    _assert_detections_match(got, exp.call(jnp.asarray(canvases)))


def test_ssd_server_answers_as_detect_u8(pair):
    """``DetectionServer`` over the SSD model: a PNG canvas answered with
    ``detect_u8``'s detections (the server's JSON rounding: scores 1e-4,
    boxes 1e-2)."""
    import io

    from PIL import Image

    from detjax_torch.serve import DetectionServer

    srv = DetectionServer(pair["model"], pair["tcfg"], batch_size=2,
                          max_wait_ms=5.0, score_threshold=0.0)
    try:
        buf = io.BytesIO()
        Image.fromarray(pair["canvases"][0]).save(buf, format="PNG")
        outs = srv.detect_bytes(buf.getvalue())
    finally:
        srv.shutdown()
    want = detjax_torch.detect_u8(pair["model"], pair["canvases"][:1],
                                  pair["tcfg"])
    nv = int(want.num_valid[0])
    assert len(outs) == nv > 10
    np.testing.assert_allclose([d["score"] for d in outs],
                               want.scores[0, :nv].numpy(), atol=1.01e-4)
    np.testing.assert_allclose(np.asarray([d["box"] for d in outs]),
                               want.boxes[0, :nv].numpy(), atol=1.1e-2)


def test_ssd_cli_train_export_detect_evaluate(tmp_path, capsys):
    """``--preset ssd_512`` through the train, export, detect and evaluate
    CLIs on the CPU at 64 px: a one-step checkpoint, an int8 program with
    fp32 input that passes its selftest against the live int8 engine,
    annotated images, COCO stats."""
    from PIL import Image

    from detjax_torch.cli import detect as cli_detect
    from detjax_torch.cli import evaluate as cli_evaluate
    from detjax_torch.cli import export as cli_export
    from detjax_torch.cli import train as cli_train

    sets = [a for s in ("model.image_size=(64,64)", "model.dtype=float32",
                        "model.backbone_depth=18", "model.fpn_channels=32",
                        "model.num_classes=8")
            for a in ("--set", s)]
    ckpt = str(tmp_path / "ckpt")
    cli_train.main(["--preset", "ssd_512", "--synthetic", "--device", "cpu",
                    "--steps", "1", "--ckpt-dir", ckpt] + sets)
    common = ["--preset", "ssd_512", "--ckpt-dir", ckpt, "--device",
              "cpu"] + sets
    img = tmp_path / "a.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (50, 70, 3), np.uint8)).save(img)
    prog = str(tmp_path / "ssd_int8.pt2")
    cli_export.main([prog, "--batch-size", "2", "--selftest",
                     "--int8-calibrate", str(img)] + common)
    assert "-> OK" in capsys.readouterr().out
    written = cli_detect.main([str(img), "--out-dir", str(tmp_path / "out"),
                               "--score-threshold", "0.0"] + common)
    assert len(written) == 1
    assert np.asarray(Image.open(written[0])).shape == (50, 70, 3)
    res = cli_evaluate.main(["--synthetic", "--max-images", "4"] + common)
    assert len(res.stats) == 12

"""The port's evaluation against detjax's, on the CPU: the COCO and VOC
metrics on the same detections (exactly equal, with the native core and
with ``DETJAX_NATIVE=0``), and ``evaluate`` / ``run_coco_eval_protocol``
end to end on weights carried by ``from_jax`` into an fp32 CPU model
(detections within the bars of tests/test_torch_e2e.py, stats within
those of scripts/e2e_gate.py), and the evaluator's GT built once before
the loader threads start."""

import numpy as np
import pytest
import torch

import jax

from detjax import modeling as jmodeling
from detjax.config import get_config as j_get_config
from detjax.data import SyntheticDetectionDataset as JSynthetic
from detjax.evaluation import coco_map as j_coco_map
from detjax.evaluation import evaluator as j_evaluator
from detjax.evaluation import protocol as j_protocol
from detjax.evaluation import voc as j_voc
from detjax.utils.torch_import import (
    export_full_detector,
    import_detector_into_variables,
)

import detjax_torch
from detjax_torch import native as t_native
from detjax_torch.data import CSVDataset
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.evaluation import coco_map as t_coco_map
from detjax_torch.evaluation import evaluator as t_evaluator
from detjax_torch.evaluation import protocol as t_protocol
from detjax_torch.evaluation import voc as t_voc
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100",
         "ARs", "ARm", "ARl")


# ---- the metrics on the same detections ----


def scene_set(seed, n_img=12, k=5, crowd=0.15, tie_decimals=1):
    """Ground truth over all three area ranges with crowd boxes, and
    detections jittered from it plus false positives, with scores rounded
    to ``tie_decimals`` so that ties are common. Image 0 has no GT, image
    1 no detection."""
    rng = np.random.default_rng(seed)
    gts, dets = {}, {}
    for img in range(n_img):
        g = 0 if img == 0 else int(rng.integers(1, 7))
        side = rng.choice([12.0, 48.0, 160.0], g) * rng.uniform(0.7, 1.3, g)
        xy = rng.uniform(0, 400, (g, 2))
        boxes = np.concatenate([xy, xy + side[:, None]
                                * rng.uniform(0.6, 1.4, (g, 2))], 1)
        labels = rng.integers(0, k, g)
        iscrowd = rng.uniform(size=g) < crowd
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) \
            * rng.uniform(0.6, 1.0, g)
        gts[img] = {"boxes": boxes, "labels": labels, "iscrowd": iscrowd,
                    "areas": areas}
        if img == 1:
            continue
        hit = rng.uniform(size=g) < 0.8
        jit = boxes[hit] + rng.normal(0, 0.06, (int(hit.sum()), 4)) \
            * side[hit, None]
        n_fp = int(rng.integers(0, 6))
        fxy = rng.uniform(0, 400, (n_fp, 2))
        fp = np.concatenate([fxy, fxy + rng.uniform(8, 120, (n_fp, 2))], 1)
        d_boxes = np.concatenate([jit, fp])
        d_labels = np.concatenate([labels[hit], rng.integers(0, k, n_fp)])
        d_scores = np.round(rng.uniform(0.05, 1.0, len(d_boxes)),
                            tie_decimals)
        dets[img] = {"boxes": d_boxes.astype(np.float32),
                     "scores": d_scores.astype(np.float32),
                     "labels": d_labels.astype(np.int32)}
    return gts, dets


def _coco(mod, gts, dets, cats=None):
    g = {i: mod.GroundTruth(**v) for i, v in gts.items()}
    return mod.evaluate_detections(g, dets, cats)


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluate_detections_exactly_equal_to_detjax(seed, native,
                                                     monkeypatch):
    monkeypatch.setenv("DETJAX_NATIVE", native)
    assert t_coco_map._use_native() == (native == "1")
    gts, dets = scene_set(seed)
    cats = list(range(5)) if seed % 2 else None
    got = _coco(t_coco_map, gts, dets, cats)
    want = _coco(j_coco_map, gts, dets, cats)
    assert got.stats == want.stats
    assert got.per_class_ap == want.per_class_ap
    assert got.stats["AP"] > 0.2  # far from 0: the matches decide it
    assert min(got.stats[k] for k in ("APs", "APm", "APl")) > 0


def test_native_and_numpy_cores_give_equal_stats(monkeypatch):
    gts, dets = scene_set(7, n_img=20, tie_decimals=2)
    monkeypatch.setenv("DETJAX_NATIVE", "1")
    a = _coco(t_coco_map, gts, dets)
    monkeypatch.setenv("DETJAX_NATIVE", "0")
    b = _coco(t_coco_map, gts, dets)
    assert a.stats == b.stats and a.per_class_ap == b.per_class_ap


@pytest.mark.parametrize("case", ["empty_dets", "empty_gt_class", "all_crowd"])
def test_evaluate_detections_corner_cases_equal_to_detjax(case):
    gts, dets = scene_set(11)
    if case == "empty_dets":
        dets = {}
    elif case == "empty_gt_class":  # a category no image has
        gts = {i: {**g, "labels": np.minimum(g["labels"], 3)}
               for i, g in gts.items()}
    else:
        gts = {i: {**g, "iscrowd": np.ones(len(g["labels"]), bool)}
               for i, g in gts.items()}
    got = _coco(t_coco_map, gts, dets, list(range(5)))
    want = _coco(j_coco_map, gts, dets, list(range(5)))
    assert got.stats == want.stats
    assert got.per_class_ap == want.per_class_ap


def test_coco_metric_streaming_equal_to_detjax():
    gts, dets = scene_set(5)
    t_m, j_m = t_coco_map.COCOMetric(), j_coco_map.COCOMetric()
    for i, g in gts.items():
        d = dets.get(i, {"boxes": np.zeros((0, 4), np.float32),
                         "scores": np.zeros(0, np.float32),
                         "labels": np.zeros(0, np.int32)})
        pad = 3  # padded rows beyond num_valid, label -1
        boxes = np.concatenate([d["boxes"], np.zeros((pad, 4), np.float32)])
        scores = np.concatenate([d["scores"], np.zeros(pad, np.float32)])
        labels = np.concatenate([d["labels"], -np.ones(pad, np.int32)])
        for mod, m in ((t_coco_map, t_m), (j_coco_map, j_m)):
            m.add(i, mod.GroundTruth(**g), boxes, scores, labels,
                  num_valid=len(d["labels"]))
    got, want = t_m.compute(), j_m.compute()
    assert got.stats == want.stats and got.per_class_ap == want.per_class_ap


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("thr", [0.5, 0.75])
def test_evaluate_voc_equal_to_detjax(seed, thr, native, monkeypatch):
    monkeypatch.setenv("DETJAX_NATIVE", native)
    gts, dets = scene_set(20 + seed)
    names = ["a", "b", None, "d", "e"]
    got = t_voc.evaluate_voc(gts, dets, 5, thr, names)
    want = j_voc.evaluate_voc(gts, dets, 5, thr, names)
    assert got == want and got["mAP"] > 0.2


# ---- evaluate end to end ----

_OVR = {"model.backbone_depth": 18, "model.image_size": (64, 64),
        "model.num_classes": 4, "model.dtype": "float32",
        "model.fpn_channels": 32, "model.head_channels": 32,
        "train.max_gt": 4, "eval.batch_size": 2, "data.host_workers": 2,
        "data.eval_scale_minmax": (64, 128)}
# the three protocol buckets at (64, 128): 64x64, 64x128, 128x64
_SIZES = ((96, 96), (64, 128), (128, 64))


def _carried(ovr, seed=1):
    """detjax variables and the port's CPU model on the same weights, the
    class output perturbed so that a sparse set of scores clears the 0.05
    floor (the recipe of tests/test_torch_e2e.py)."""
    rng = np.random.default_rng(seed)
    jcfg = j_get_config("retinanet_r50_640", **ovr)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **ovr)
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(seed))
    sd = dict(export_full_detector(variables["params"],
                                   variables["batch_stats"], depth=18))
    w = "classificationModel.output.weight"
    b = "classificationModel.output.bias"
    sd[w] = (sd[w] + rng.normal(0, 0.08, sd[w].shape)).astype(np.float32)
    sd[b] = (sd[b] + rng.normal(0, 1.2, sd[b].shape)).astype(np.float32)
    r = "regressionModel.output.weight"
    sd[r] = (sd[r] * 3.0).astype(np.float32)
    variables = import_detector_into_variables(variables, sd, depth=18)
    model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax(
        jax.tree.map(np.asarray, jax.device_get(variables["params"])),
        jax.tree.map(np.asarray, jax.device_get(variables["batch_stats"])),
        tcfg.model), strict=True)
    return jcfg, tcfg, variables, model


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg, variables, model = _carried(_OVR)
    # the dataset of tests/test_evaluator.py; the protocol set cycles
    # three source shapes, one a canvas
    kw = dict(num_images=5, image_size=(96, 96), num_classes=4,
              max_objects=2, seed=2)
    pkw = dict(kw, num_images=7, image_sizes=_SIZES)
    return (jcfg, tcfg, variables, model,
            (SyntheticDetectionDataset(**kw), JSynthetic(**kw)),
            (SyntheticDetectionDataset(**pkw), JSynthetic(**pkw)))


def _hold_detections(got, want, scales):
    """Per image: keep-sets identical, scores within 2e-5, boxes within
    5e-3 in canvas units."""
    got = {i: (b, s, l) for i, b, s, l in got}
    want = {i: (b, s, l) for i, b, s, l in want}
    assert sorted(got) == sorted(want)
    kept = 0
    for i, (b, s, lab) in got.items():
        wb, ws, wl = want[i]
        np.testing.assert_array_equal(lab, wl)
        np.testing.assert_allclose(s, ws, rtol=0, atol=2e-5)
        np.testing.assert_allclose(b * scales[i], wb * scales[i], rtol=0,
                                   atol=5e-3)
        kept += len(lab)
    assert kept > 20, "too few detections to be a test"


def _hold_stats(got, want):
    for k in STATS:
        bar = 0.05 if k == "AR1" else 0.002
        assert abs(got.stats[k] - want.stats[k]) <= bar, k


def test_iter_detections_within_the_bars_of_detjax(carried):
    jcfg, tcfg, variables, model, (t_ds, j_ds), _ = carried
    got = list(t_evaluator.iter_detections(model, t_ds, tcfg))
    want = list(j_evaluator.iter_detections(variables, j_ds, jcfg))
    _hold_detections(got, want, {i: 64 / 96 for i in range(5)})


def test_evaluate_within_the_bars_of_detjax(carried):
    jcfg, tcfg, variables, model, (t_ds, j_ds), _ = carried
    got = detjax_torch.evaluate(model, t_ds, tcfg)
    want = j_evaluator.run_coco_eval(variables, j_ds, jcfg)
    _hold_stats(got, want)
    assert sorted(got.per_class_ap) == sorted(want.per_class_ap)


def test_run_voc_eval_within_the_bars_of_detjax(carried):
    jcfg, tcfg, variables, model, (t_ds, j_ds), _ = carried
    got = t_evaluator.run_voc_eval(model, t_ds, tcfg)
    want = j_evaluator.run_voc_eval(variables, j_ds, jcfg)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 0.002, k


def test_protocol_buckets_equal_to_detjax(carried):
    _, tcfg, _, _, _, (t_ds, j_ds) = carried
    sizes = t_protocol.image_sizes(t_ds)
    assert sizes == j_protocol.image_sizes(j_ds)
    buckets = t_protocol.bucket_by_canvas(sizes, 64, 128)
    assert buckets == j_protocol.bucket_by_canvas(sizes, 64, 128)
    assert sorted(buckets) == [(64, 64), (64, 128), (128, 64)]


def test_protocol_detections_within_the_bars_of_detjax(carried):
    from detjax_torch.data.transforms import protocol_scale

    jcfg, tcfg, variables, model, _, (t_ds, j_ds) = carried
    got = list(t_protocol.iter_detections_protocol(model, t_ds, tcfg))
    want = list(j_protocol.iter_detections_protocol(variables, j_ds, jcfg))
    scales = {i: protocol_scale(*_SIZES[i % 3], 64, 128) for i in range(7)}
    _hold_detections(got, want, scales)


def test_run_coco_eval_protocol_within_the_bars_of_detjax(carried):
    jcfg, tcfg, variables, model, _, (t_ds, j_ds) = carried
    got = t_protocol.run_coco_eval_protocol(model, t_ds, tcfg)
    want = j_protocol.run_coco_eval_protocol(variables, j_ds, jcfg)
    _hold_stats(got, want)


def test_detect_fn_overrides_and_max_images_caps(carried):
    _, tcfg, _, model, (t_ds, _), _ = carried
    seen = []

    def twin_route(m, x):
        seen.append(tuple(x.shape))
        return detjax_torch.detect(m, x, tcfg, nms_backend="torch")

    a = list(t_evaluator.iter_detections(model, t_ds, tcfg,
                                         detect_fn=twin_route))
    b = list(t_evaluator.iter_detections(model, t_ds, tcfg))
    assert seen == [(2, 64, 64, 3)] * 3
    for (i, bb, s, lab), (j, wb, ws, wl) in zip(a, b):
        assert i == j
        for u, v in ((bb, wb), (s, ws), (lab, wl)):
            np.testing.assert_array_equal(u, v)
    assert len(list(t_evaluator.iter_detections(model, t_ds, tcfg,
                                                max_images=3))) == 3


def test_mesh_is_not_ported(carried):
    """evaluate takes a detjax_torch.parallel.Mesh (sharded evaluation is
    ``tests/test_torch_port_parallel.py``'s, over a space axis
    ``tests/test_torch_port_spatial.py``'s): another object is refused; a
    space axis over one process's devices, and another engine
    (``detect_fn``) on a space axis, name ROADMAP Queue 1 #8; a canvas
    that the space axis cannot split through the backbone is refused
    before any collective."""
    import dataclasses

    from detjax_torch.parallel import Mesh

    _, tcfg, _, model, (t_ds, _), _ = carried
    with pytest.raises(TypeError, match="Mesh"):
        detjax_torch.evaluate(model, t_ds, tcfg, mesh=object())
    local = Mesh((torch.device("cpu"),) * 2, space=2)
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        detjax_torch.evaluate(model, t_ds, tcfg, mesh=local)
    ranks = Mesh((torch.device("cpu"),), group=object(), world_size=2,
                 space=2)
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        list(t_evaluator.iter_detections(model, t_ds, tcfg, mesh=ranks,
                                         detect_fn=lambda m, x: None))
    odd = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, image_size=(96, 96)))
    with pytest.raises(ValueError, match="32 x space"):
        detjax_torch.evaluate(model, t_ds, odd, mesh=ranks)


def test_evaluate_runs_on_the_model_device_only(carried):
    """evaluate takes the model's device from the model; a config that
    does not describe the model is refused."""
    _, tcfg, _, model, (t_ds, _), _ = carried
    bad = detjax_torch.get_config("retinanet_r50_640",
                                  **{**_OVR, "model.num_classes": 5})
    with pytest.raises(ValueError, match="model section differs"):
        detjax_torch.evaluate(model, t_ds, bad)


# ---- ground truth built before the loader threads start ----


@pytest.fixture(scope="module")
def csv_set(tmp_path_factory):
    """A CSV dataset of JPEG scenes (three classes, a negative image)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("csv_eval")
    ds = SyntheticDetectionDataset(num_images=10, image_size=(64, 64),
                                   num_classes=3, max_objects=3, seed=6)
    rows = []
    for i in range(len(ds)):
        rec = ds[i]
        name = f"scene{i:02d}.jpg"
        Image.fromarray(rec["image"]).save(root / name, quality=95)
        if i == 7:
            rows.append(f"{name},,,,,")
            continue
        for bx, lab in zip(rec["boxes"], rec["labels"]):
            rows.append(f"{name},{','.join(str(int(v)) for v in bx)},"
                        f"k{int(lab)}")
    (root / "ann.csv").write_text("\n".join(rows) + "\n")
    return root


def test_voc_over_csv_equal_with_loader_threads(csv_set):
    """detjax's evaluator toggles ``load_images`` per image while the
    loader threads read the dataset; the port builds every GT first.
    Four threads and a prefetch of two give the result of one thread."""
    ovr = {**_OVR, "model.num_classes": 3, "data.eval_scale_minmax": ()}
    _, tcfg, _, model = _carried(ovr, seed=3)
    results, kept = [], []
    for workers, prefetch in ((1, 0), (4, 2), (4, 2)):
        cfg = detjax_torch.get_config(
            "retinanet_r50_640", **{**ovr, "data.host_workers": workers,
                                    "data.prefetch": prefetch})
        ds = CSVDataset(str(csv_set / "ann.csv"),
                        {"k0": 0, "k1": 1, "k2": 2}, str(csv_set))
        results.append(t_evaluator.run_voc_eval(model, ds, cfg))
        kept.append(sum(len(l) for _, _, _, l in
                        t_evaluator.iter_detections(model, ds, cfg)))
        assert ds.load_images  # restored after the GT pass
    assert results[0] == results[1] == results[2]
    assert kept[0] > 20 and kept[0] == kept[1] == kept[2]


def test_ground_truths_equal_to_detjax_providers(csv_set):
    ds = CSVDataset(str(csv_set / "ann.csv"), {"k0": 0, "k1": 1, "k2": 2},
                    str(csv_set))
    gts = t_evaluator.ground_truths(ds)
    j_gt = j_evaluator._gt_provider(ds)
    assert sorted(gts) == list(range(10))
    for i, g in gts.items():
        w = j_gt(i)
        for f in ("boxes", "labels", "iscrowd", "areas"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_native_core_reports_its_route():
    assert t_native.available()
    assert t_coco_map._use_native()

"""The port's data layer against detjax's, on the CPU: the native library
(resize, JPEG decode, COCO IoU and matching), the host transforms, the
COCO and CSV datasets, the batch iterators and prefetch. The same inputs,
made from a seed with numpy, go through both packages; every bar is
equality (bytes, or exact values)."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from detjax import native as j_native
from detjax.data import coco as j_coco
from detjax.data import csv_dataset as j_csv
from detjax.data import pipeline as j_pipeline
from detjax.data import transforms as j_tf
from detjax.config import get_config as j_get_config

import detjax_torch
from detjax_torch import native as t_native
from detjax_torch.data import coco as t_coco
from detjax_torch.data import csv_dataset as t_csv
from detjax_torch.data import pipeline as t_pipeline
from detjax_torch.data import transforms as t_tf
from detjax_torch.data.synthetic import SyntheticDetectionDataset

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# up, down, odd, one channel, extreme aspect, the 640 -> 608 protocol step
RESIZE_CASES = [((64, 48, 3), 128, 96), ((128, 96, 3), 64, 48),
                ((100, 30, 1), 31, 99), ((5, 200, 3), 200, 5),
                ((97, 97, 3), 96, 98), ((640, 640, 3), 608, 608),
                ((375, 500, 3), 608, 811), ((33, 17, 3), 1, 1)]
# the shapes of tests/test_protocol_eval.py
MIXED_SHAPES = ((640, 480), (480, 640), (500, 375), (427, 640), (612, 612),
                (640, 426), (333, 500), (240, 320), (1024, 768), (96, 2000))


def _jpeg_bytes(img, quality=95, mode=None):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _same_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _same_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the native library ----


def test_native_builds_in_the_checkout():
    """The libraries build with detjax's flags into the port's own build
    directory, never into a cache under $HOME; the JPEG one wherever
    detjax's builds (it needs libjpeg's headers)."""
    assert t_native.available(), t_native.build_errors
    assert t_native.jpeg_available() == j_native.jpeg_available()
    assert t_native.GXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC")
    built = {p.name for p in t_native.BUILD_ROOT.glob("native-*/*.so")}
    assert "detjax_native.so" in built
    assert ("detjax_jpeg.so" in built) == t_native.jpeg_available()
    assert t_native.BUILD_ROOT == REPO / "detjax_torch" / "_build"


def test_native_sources_are_detjax_sources():
    """The C++ is a copy: identical apart from the comments naming their
    loader."""
    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.lstrip().startswith("//")]
    for name in ("detjax_native.cpp", "detjax_jpeg.cpp"):
        assert code(REPO / "detjax_torch" / "native" / name) == \
            code(REPO / "detjax" / "native" / name)


@pytest.mark.parametrize("case", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{h}x{w}"
                              for s, h, w in RESIZE_CASES])
def test_resize_bit_equal_to_detjax_and_pil(case):
    from PIL import Image

    (h, w, c), dh, dw = case
    img = np.random.default_rng(h * w + dh).integers(0, 256, (h, w, c),
                                                     dtype=np.uint8)
    got = t_native.resize_bilinear(img, dh, dw)
    np.testing.assert_array_equal(got, j_native.resize_bilinear(img, dh, dw))
    pil = np.asarray(Image.fromarray(img[..., 0] if c == 1 else img)
                     .resize((dw, dh), Image.BILINEAR))
    np.testing.assert_array_equal(got, pil.reshape(dh, dw, c))


@pytest.mark.parametrize("kind", ["rgb", "gray", "odd", "q50"])
def test_decode_jpeg_bit_equal_to_detjax(kind):
    rng = np.random.default_rng(3)
    if kind == "gray":
        data = _jpeg_bytes(rng.integers(0, 256, (37, 53), dtype=np.uint8),
                           mode="L")
    else:
        hw = (61, 97) if kind == "odd" else (96, 128)
        data = _jpeg_bytes(rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                           quality=50 if kind == "q50" else 95)
    got, want = t_native.decode_jpeg(data), j_native.decode_jpeg(data)
    if want is None:  # neither package has libjpeg on this host
        assert got is None and not t_native.jpeg_available()
        return
    assert got.shape[2] == 3
    np.testing.assert_array_equal(got, want)


def test_decode_image_falls_back_to_pil_on_other_formats():
    import io

    from PIL import Image

    img = np.random.default_rng(4).integers(0, 256, (20, 30, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert t_native.decode_jpeg(buf.getvalue()) is None
    before = dict(t_native.decode_routes)
    np.testing.assert_array_equal(t_native.decode_image(buf.getvalue()), img)
    jpg = _jpeg_bytes(img)
    with Image.open(io.BytesIO(jpg)) as im:
        pil = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(t_native.decode_image(jpg), pil)
    native = int(t_native.jpeg_available())
    assert t_native.decode_routes["pil"] == before["pil"] + 2 - native
    assert t_native.decode_routes["native"] == before["native"] + native


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_and_match_image_equal_to_detjax(seed):
    rng = np.random.default_rng(seed)
    det = rng.uniform(0, 100, (30, 2))
    det = np.concatenate([det, det + rng.uniform(1, 60, (30, 2))], 1)
    gt = rng.uniform(0, 100, (9, 2))
    gt = np.concatenate([gt, gt + rng.uniform(1, 60, (9, 2))], 1)
    crowd = rng.uniform(size=9) < 0.3
    ious = t_native.iou_xyxy(det, gt, crowd)
    np.testing.assert_array_equal(ious, j_native.iou_xyxy(det, gt, crowd))
    gt_ig = crowd | (rng.uniform(size=9) < 0.2)
    order = np.argsort(gt_ig, kind="stable")
    areas = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    thrs = np.linspace(0.5, 0.95, 10)
    for rng_ in ((0.0, 1e10), (0.0, 32.0 ** 2), (32.0 ** 2, 96.0 ** 2)):
        args = (ious[:, order], gt_ig[order], crowd[order], areas, rng_,
                thrs)
        for got, want in zip(t_native.match_image(*args),
                             j_native.match_image(*args)):
            np.testing.assert_array_equal(got, want)


def test_native_first_use_from_many_threads(tmp_path):
    """Eight threads resize at once in a fresh process whose build
    directory is empty: one build, published by rename, no temporary file
    left, every result equal to PIL's."""
    script = textwrap.dedent(f"""
        import threading, numpy as np
        from pathlib import Path
        from PIL import Image
        from detjax_torch import native
        native.BUILD_ROOT = Path({str(tmp_path)!r})
        img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), np.uint8)
        want = np.asarray(Image.fromarray(img).resize((33, 41), Image.BILINEAR))
        out, start = [], threading.Barrier(8)
        def run():
            start.wait()
            out.append(native.resize_bilinear(img, 41, 33))
        ts = [threading.Thread(target=run) for _ in range(8)]
        [t.start() for t in ts]
        [t.join(60) for t in ts]
        assert len(out) == 8 and all((o == want).all() for o in out)
        print(sorted(p.name for p in Path({str(tmp_path)!r}).rglob("*")))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = eval(proc.stdout.strip().splitlines()[-1])
    assert [n for n in names if n.endswith(".so")] == ["detjax_native.so"]
    assert not [n for n in names if n.startswith(".")]


def test_host_fallbacks_equal_the_native_route(monkeypatch):
    """Without the library the letterbox resizes through PIL, with the
    same bytes."""
    img = np.random.default_rng(5).integers(0, 256, (75, 101, 3), np.uint8)
    boxes = np.asarray([[3, 4, 50, 60]], np.float32)
    want = t_tf.letterbox(img, boxes, (128, 96))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_build_failed", True)
    assert not t_native.available()
    got = t_tf.letterbox(img, boxes, (128, 96))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---- host transforms ----


@pytest.mark.parametrize("hw", MIXED_SHAPES)
def test_protocol_canvas_byte_equal_to_detjax(hw):
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    boxes = np.asarray([[1.5, 2.0, 90.0, 80.0], [0, 0, hw[1], hw[0]]],
                       np.float32)
    canvas_hw, scale = t_tf.protocol_canvas(*hw)
    assert (canvas_hw, scale) == j_tf.protocol_canvas(*hw)
    got = t_tf.letterbox_protocol(img, boxes, canvas_hw)
    want = j_tf.letterbox_protocol(img, boxes, canvas_hw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_letterbox_protocol_rejects_a_small_canvas():
    img = np.zeros((480, 640, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds canvas"):
        t_tf.letterbox_protocol(img, np.zeros((0, 4), np.float32),
                                (608, 800))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_equal_to_detjax(seed):
    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    xy = rng.uniform(0, 80, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (6, 2))],
                           1).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    if seed == 2:  # a negative image
        boxes, labels = boxes[:0], labels[:0]
    got = t_tf.random_crop(img, boxes, labels, np.random.default_rng(seed),
                           0.3, 1.0)
    want = j_tf.random_crop(img, boxes, labels, np.random.default_rng(seed),
                            0.3, 1.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hflip_and_normalize_equal_to_detjax():
    rng = np.random.default_rng(6)
    boxes = rng.uniform(0, 50, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(t_tf.hflip_boxes(boxes, 64.0),
                                  j_tf.hflip_boxes(boxes, 64.0))
    img = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_tf.normalize_image(img),
                                  j_tf.normalize_image(img))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    np.testing.assert_array_equal(t_tf.normalize_image(img, mean, std),
                                  j_tf.normalize_image(img, mean, std))


# ---- datasets ----


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A COCO instances JSON and JPEG files written from synthetic scenes:
    crowd annotations, a degenerate box, an image without annotations,
    category ids that are not contiguous."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco")
    ds = SyntheticDetectionDataset(num_images=6, num_classes=5,
                                   max_objects=3, seed=9, crowd_prob=0.3,
                                   image_sizes=((60, 80), (80, 60), (45, 70)))
    cat_ids = [1, 3, 7, 18, 44]
    images, anns = [], []
    for i in range(len(ds)):
        rec = ds[i]
        h, w = rec["size"]
        name = f"{i:04d}.jpg"
        Image.fromarray(rec["image"]).save(root / name, quality=95)
        images.append({"id": 100 + i, "file_name": name, "height": h,
                       "width": w})
        if i == 4:
            continue  # an image without annotations
        for b, lab, crowd in zip(rec["boxes"], rec["labels"],
                                 rec["iscrowd"]):
            x1, y1, x2, y2 = (float(v) for v in b)
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": cat_ids[int(lab)],
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1) * 0.9,
                         "iscrowd": int(crowd)})
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": 3,
                 "bbox": [5, 5, 0.5, 10], "area": 5.0, "iscrowd": 0})
    (root / "instances.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in cat_ids]}))
    return root


@pytest.mark.parametrize("load_images", [True, False])
def test_coco_dataset_records_equal_to_detjax(coco_dir, load_images):
    ann = str(coco_dir / "instances.json")
    t = t_coco.CocoDataset(ann, str(coco_dir), load_images=load_images)
    j = j_coco.CocoDataset(ann, str(coco_dir), load_images=load_images)
    assert len(t) == len(j) == 6
    assert (t.cat_id_to_label, t.label_to_cat_id, t.class_names,
            t.num_classes) == (j.cat_id_to_label, j.label_to_cat_id,
                               j.class_names, j.num_classes)
    for i in range(len(t)):
        _same_records(t[i], j[i])
        for filt in (False, True):
            image_id = t.images[i]["id"]
            _same_records(t.load_annotations(image_id, filt),
                          j.load_annotations(image_id, filt))
    assert t_coco.COCO_CLASSES == j_coco.COCO_CLASSES


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(12)
    rows = []
    for i in range(7):
        h, w = (48, 64) if i % 2 else (64, 40)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(root / f"img{i}.jpg", quality=95)
        if i == 3:
            rows.append(f"img{i}.jpg,,,,,")  # a negative image
            continue
        for _ in range(int(rng.integers(1, 4))):
            x1, y1 = rng.integers(0, 20, 2)
            x2, y2 = x1 + rng.integers(4, 20), y1 + rng.integers(4, 20)
            rows.append(f"img{i}.jpg,{x1},{y1},{x2},{y2},"
                        f"{['cat', 'dog', 'bird'][int(rng.integers(0, 3))]}")
    (root / "ann.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("cat,0\ndog,1\nbird,2\n")
    return root


@pytest.mark.parametrize("load_images", [True, False])
def test_csv_dataset_records_equal_to_detjax(csv_dir, load_images):
    args = (str(csv_dir / "ann.csv"), str(csv_dir / "classes.csv"),
            str(csv_dir))
    t = t_csv.CSVDataset(*args, load_images=load_images)
    j = j_csv.CSVDataset(*args, load_images=load_images)
    assert (len(t), t.class_names, t.num_classes) == (len(j), j.class_names,
                                                      j.num_classes)
    for i in range(len(t)):
        _same_records(t[i], j[i])
    assert t_csv.load_class_map(args[1]) == j_csv.load_class_map(args[1])


def test_csv_dataset_rejects_unknown_classes_and_degenerate_boxes(tmp_path):
    (tmp_path / "a.csv").write_text("x.jpg,1,1,5,5,cow\n")
    (tmp_path / "b.csv").write_text("x.jpg,5,1,5,5,cat\n")
    with pytest.raises(ValueError, match="unknown class"):
        t_csv.CSVDataset(str(tmp_path / "a.csv"), {"cat": 0})
    with pytest.raises(ValueError, match="degenerate box"):
        t_csv.CSVDataset(str(tmp_path / "b.csv"), {"cat": 0})


# ---- iterators and prefetch ----

_TRAIN_OVR = {"model.image_size": (64, 96), "train.batch_size": 3,
              "train.max_gt": 5, "train.seed": 4, "data.prefetch": 2,
              "eval.batch_size": 4}


def _cfgs(**extra):
    ovr = {**_TRAIN_OVR, **extra}
    return (detjax_torch.get_config("retinanet_r50_640", **ovr),
            j_get_config("retinanet_r50_640", **ovr))


def _scenes(n=10):
    return SyntheticDetectionDataset(
        num_images=n, num_classes=4, max_objects=4, seed=1,
        image_sizes=((70, 90), (90, 70), (64, 64)))


@pytest.mark.parametrize("workers", [1, 4])
def test_train_batches_byte_equal_to_detjax(workers):
    """Two epochs (3 batches each of 10 images, crop on), then the stream
    resumed with iter_from(4), equal batch for batch."""
    tcfg, jcfg = _cfgs(**{"data.host_workers": workers,
                          "data.random_crop": True})
    ds = _scenes()
    t_it = t_pipeline.make_train_iterator(ds, tcfg)
    j_it = j_pipeline.make_train_iterator(ds, jcfg)
    assert t_it.batches_per_epoch() == j_it.batches_per_epoch() == 3
    got, want = iter(t_it), iter(j_it)
    t_batches = [next(got) for _ in range(6)]
    for t_b in t_batches:
        _same_batches(t_b, next(want))
    resumed = t_it.iter_from(4)
    for k in (4, 5):
        _same_batches(next(resumed), t_batches[k])
    jr = j_it.iter_from(4)
    _same_batches(t_batches[4], next(jr))


def test_train_batches_do_not_depend_on_the_workers():
    tcfg1, _ = _cfgs(**{"data.host_workers": 1})
    tcfg8, _ = _cfgs(**{"data.host_workers": 8, "data.prefetch": 0})
    ds = _scenes()
    a = iter(t_pipeline.make_train_iterator(ds, tcfg1))
    b = iter(t_pipeline.make_train_iterator(ds, tcfg8))
    for _ in range(4):
        _same_batches(next(a), next(b))


@pytest.mark.parametrize("minmax", [(), (48, 80)])
def test_eval_batches_and_padding_equal_to_detjax(minmax):
    """10 images at batch 4: the final batch holds 2 images and 2 copies of
    the last one with image_id -1."""
    tcfg, jcfg = _cfgs(**{"data.eval_scale_minmax": minmax})
    ds = _scenes()
    got = list(t_pipeline.make_eval_iterator(ds, tcfg))
    want = list(j_pipeline.make_eval_iterator(ds, jcfg))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_batches(a, b)
    assert got[-1]["image_id"].tolist() == [8, 9, -1, -1]


def test_per_host_shard_follows_torch_distributed(monkeypatch):
    """Without an initialised process group a process is rank 0 of 1; with
    one, it takes its stride of the shuffle and its share of the batch,
    the batches detjax's iterator gives for that shard."""
    tcfg, _ = _cfgs(**{"train.batch_size": 4, "data.prefetch": 0})
    ds = _scenes(12)
    assert t_pipeline._process_shard() == (0, 1)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    it = t_pipeline.make_train_iterator(ds, tcfg, per_host=True)
    assert (it.bs, it.shard_index, it.num_shards) == (2, 1, 2)
    ref = j_pipeline.DetectionIterator(
        ds, 2, tcfg.model.image_size, max_gt=5, seed=4, crop=True,
        prefetch=0, shard_index=1, num_shards=2)
    a, b = iter(it), iter(ref)
    for _ in range(4):
        _same_batches(next(a), next(b))
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="not divisible"):
        t_pipeline.make_train_iterator(ds, tcfg, per_host=True)


def test_prefetch_propagates_worker_exceptions():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"record {i}")

    it = t_pipeline.DetectionIterator(Broken(), 2, (32, 32), prefetch=2)
    with pytest.raises(KeyError, match="record"):
        next(iter(it))


def test_device_prefetch_on_the_cpu_gives_plain_tensors():
    tcfg, _ = _cfgs()
    batches = list(t_pipeline.make_eval_iterator(_scenes(), tcfg))
    got = list(t_pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        for k, v in b.items():
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), v)
    only = next(t_pipeline.device_prefetch(iter(batches), "cpu",
                                           keys=("images",)))
    assert isinstance(only["images"], torch.Tensor)
    assert only["image_id"] is batches[0]["image_id"]


@pytest.mark.parametrize("transfer_s,step_s", [(0.1, 1.0), (0.6, 1.0),
                                               (0.5, 1.0)])
def test_prefetch_is_profitable_equal_to_detjax(transfer_s, step_s):
    assert t_pipeline.prefetch_is_profitable(transfer_s, step_s) == \
        j_pipeline.prefetch_is_profitable(transfer_s, step_s)

"""The port's serving layer on the CPU, and the port's ground rules: no
JAX import anywhere in it, and no entry point that drops to the CPU
unasked."""

import ast
import io
import json
import pathlib
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import detjax_torch
from detjax_torch.parallel import Mesh
from detjax_torch.serve import DetectionServer, MicroBatcher, Overloaded

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
_OVR = {"model.image_size": (64, 64), "model.num_classes": 4,
        "model.backbone_depth": 18, "model.dtype": "float32",
        "model.prior_prob": 0.3, "model.fpn_channels": 32,
        "model.head_channels": 32, "eval.pre_nms_top_k": 50,
        "eval.max_detections": 10}


def _cfg():
    return detjax_torch.get_config("retinanet_r50_640", **_OVR)


@pytest.fixture(scope="module")
def model():
    return detjax_torch.build_model(_cfg(), seed=5, device="cpu")


def _canvases(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                np.uint8)


def _direct(model, canvas, batch_size):
    """A direct detect of one canvas, in slot 0 of a zero-padded batch of
    the server's size (the shape the server runs)."""
    batch = np.zeros((batch_size, 64, 64, 3), np.uint8)
    batch[0] = canvas
    det = detjax_torch.detect_u8(model, batch, _cfg())
    return tuple(t[0].numpy() for t in det[:3]) + (int(det.num_valid[0]),)


def _assert_same(got, want):
    gb, gs, gl, gn = got
    wb, ws, wl, wn = want
    assert gn == wn
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)


def test_microbatcher_pads_and_coalesces():
    seen = []

    def run_batch(batch):
        seen.append(batch.copy())
        return [float(batch[i].mean()) for i in range(batch.shape[0])]

    mb = MicroBatcher(run_batch, batch_size=4, canvas_hw=(8, 8),
                      max_wait_ms=50.0)
    results = [None] * 3

    def submit(i):
        results[i] = mb.submit(np.full((8, 8, 3), 10 * (i + 1), np.uint8))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.close()
    assert sorted(results) == [10.0, 20.0, 30.0]
    assert all(b.shape == (4, 8, 8, 3) for b in seen)
    other = MicroBatcher(run_batch, 2, (8, 8))
    try:
        with pytest.raises(ValueError, match="canvas must be uint8"):
            other.submit(np.zeros((8, 8, 3)))
    finally:
        other.close()


def test_microbatcher_sheds_load_when_full():
    release = threading.Event()

    def run_batch(batch):
        release.wait(10)
        return [0.0] * batch.shape[0]

    mb = MicroBatcher(run_batch, batch_size=1, canvas_hw=(4, 4),
                      max_wait_ms=1.0, max_queue_batches=1)
    canvas = np.zeros((4, 4, 3), np.uint8)
    t1 = threading.Thread(target=mb.submit, args=(canvas,))
    t1.start()
    while mb.submitted < 1 or not mb._q.empty():
        threading.Event().wait(0.01)  # the worker holds request 1
    t2 = threading.Thread(target=mb.submit, args=(canvas,))
    t2.start()
    while mb.submitted < 2:
        threading.Event().wait(0.01)  # request 2 fills the queue
    with pytest.raises(Overloaded):
        mb.submit(canvas)
    release.set()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert mb.completed == 2 and mb.rejected == 1
    mb.close()


def test_batcher_concurrent_requests_equal_direct_detect(model):
    """8 concurrent submits coalesce into batches of 4 and each answer
    equals a direct detect of the same canvas."""
    srv = DetectionServer(model, _cfg(), batch_size=4, max_wait_ms=50.0,
                          score_threshold=0.0)
    canvases = _canvases(8, seed=1)
    outs = [None] * 8

    def hit(i):
        outs[i] = srv.batcher.submit(canvases[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.shutdown()
    assert srv.batcher.completed == 8
    assert max(o[3] for o in outs) > 0, "no detections to compare"
    for i in range(8):
        _assert_same(outs[i], _direct(model, canvases[i], 4))


def _png(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_http_server_answers_concurrent_requests(model):
    """GET /healthz, then 6 concurrent POST /detect with 64x64 PNG bodies
    (letterbox scale 1): each answer equals a direct detect, formatted as
    the server formats it."""
    names = ("a", "b", "c", "d")
    srv = DetectionServer(model, _cfg(), batch_size=4, max_wait_ms=20.0,
                          score_threshold=0.0, class_names=names)
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    try:
        assert ready.wait(120)
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["batch_size"] == 4
        assert health["image_size"] == [64, 64]

        canvases = _canvases(6, seed=2)
        outs = [None] * 6

        def hit(i):
            req = urllib.request.Request(f"{base}/detect",
                                         data=_png(canvases[i]))
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.loads(r.read())["detections"]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()
    assert sum(len(o) for o in outs) > 0
    for i in range(6):
        boxes, scores, labels, nv = _direct(model, canvases[i], 4)
        assert [d["label"] for d in outs[i]] == labels[:nv].tolist()
        assert [d["class"] for d in outs[i]] == [names[k] for k in
                                                 labels[:nv]]
        np.testing.assert_allclose([d["score"] for d in outs[i]],
                                   np.round(scores[:nv], 4), atol=1.01e-4)
        want_boxes = np.clip(boxes[:nv], 0, 64)
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in outs[i]]).reshape(-1, 4),
            want_boxes, atol=1.1e-2)


def test_buckets_route_by_image_size(model):
    srv = DetectionServer(model, _cfg(), batch_size=2, score_threshold=0.0,
                          buckets=(32, 64))
    small, large = (b for _, b in srv._buckets)
    srv.detect_bytes(_png(_canvases(1)[0][:30, :24]))
    assert small.submitted == 1 and large.submitted == 0
    srv.detect_bytes(_png(np.zeros((90, 120, 3), np.uint8)))
    assert large.submitted == 1
    srv.shutdown()


_SPACE_RANKS = Mesh((torch.device("cpu"),), group=object(), world_size=2,
                    space=2)


@pytest.mark.parametrize("kw,error,match", [
    pytest.param({"mesh": Mesh((torch.device("cpu"),) * 2, space=2)},
                 None, None, id="kw2-parallel"),
    pytest.param({"mesh": _SPACE_RANKS}, ValueError, "multi-process",
                 id="space-ranks"),
    pytest.param({"mesh": _SPACE_RANKS, "engine": "int8"}, ValueError,
                 "multi-process", id="space-int8"),
    pytest.param({"mesh": _SPACE_RANKS, "engine": "some_program.pt2"},
                 ValueError, "requires the fp or int8 engine",
                 id="space-program"),
])
def test_unported_engines_name_their_slice(model, kw, error, match):
    """Serving over a ``space`` axis, detjax's order of checks: a
    single-process (data, space) mesh serves (its answers equal the
    unsplit server's; the whole comparison with detjax's spatial server
    is ``tests/test_torch_port_space_serve.py``'s); a multi-process mesh
    is refused as serving (it trains), with any engine; a saved program
    on any mesh gets detjax's ValueError before anything else."""
    if error is not None:
        with pytest.raises(error, match=match):
            DetectionServer(model, _cfg(), **kw)
        return
    canvases = _canvases(8, seed=3)
    split = DetectionServer(model, _cfg(), score_threshold=0.0, **kw)
    try:
        got = split._runs[0](canvases)
    finally:
        split.shutdown()
    want = detjax_torch.detect_u8(model, canvases, _cfg())
    assert int(want.num_valid.sum()) > 10
    for i, g in enumerate(got):
        _assert_same(g, tuple(t[i].numpy() for t in want[:3])
                     + (int(want.num_valid[i]),))


def _http_answers(srv, canvases):
    """POST each canvas as a PNG to a running ``srv``, concurrently; the
    ``detections`` of each answer."""
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    outs = [None] * len(canvases)
    try:
        assert ready.wait(120)
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["engine"] == srv.engine

        def hit(i):
            req = urllib.request.Request(f"{base}/detect",
                                         data=_png(canvases[i]))
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.loads(r.read())["detections"]
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(canvases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()
    return outs


def _assert_answers(outs, canvases, detect_batch, batch_size):
    """Each answer equals ``detect_batch`` of its canvas in slot 0 of a
    zero-padded batch, within the JSON's rounding (scores 1e-4, boxes
    1e-2)."""
    assert sum(len(o) for o in outs) > 0, "no detections to compare"
    for out, canvas in zip(outs, canvases):
        batch = np.zeros((batch_size, 64, 64, 3), np.uint8)
        batch[0] = canvas
        det = detect_batch(batch)
        nv = int(det.num_valid[0])
        assert [d["label"] for d in out] == det.labels[0, :nv].tolist()
        np.testing.assert_allclose([d["score"] for d in out],
                                   np.round(det.scores[0, :nv].numpy(), 4),
                                   atol=1.01e-4)
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in out]).reshape(-1, 4),
            np.clip(det.boxes[0, :nv].numpy(), 0, 64), atol=1.1e-2)


def test_int8_server_answers_http(model):
    """engine="int8" calibrated on uint8 canvases: 3 concurrent requests,
    each equal to a direct ``detect_int8_u8`` on a qtree calibrated the
    same way (the server normalizes the canvases to fp32 first)."""
    from detjax_torch.data.pipeline import normalize_u8

    cal = _canvases(4, seed=7)
    srv = DetectionServer(model, _cfg(), engine="int8", batch_size=2,
                          max_wait_ms=20.0, score_threshold=0.0,
                          calibration=cal)
    canvases = _canvases(3, seed=8)
    outs = _http_answers(srv, canvases)
    cfg = _cfg()
    qtree = detjax_torch.quantize_model(model, cfg, normalize_u8(
        torch.from_numpy(cal), cfg.data.mean, cfg.data.std))
    _assert_answers(outs, canvases,
                    lambda b: detjax_torch.detect_int8_u8(qtree, b, cfg), 2)


def test_int8_server_needs_calibration_of_the_served_shape(model):
    with pytest.raises(ValueError, match="requires calibration"):
        DetectionServer(model, _cfg(), engine="int8")
    with pytest.raises(ValueError, match="calibration must be"):
        DetectionServer(model, _cfg(), engine="int8",
                        calibration=np.zeros((2, 32, 32, 3), np.uint8))


def test_artifact_server_answers_http(model, tmp_path):
    """engine=<a saved detect program>: the uint8 program answers 3
    concurrent requests, each equal to a direct ``detect_u8``; a program
    of another batch, and buckets, are refused."""
    from detjax_torch.export import save_detect

    path = str(tmp_path / "detect.pt2")
    save_detect(path, model, _cfg(), batch_size=2, input_format="u8")
    with pytest.raises(ValueError, match="exported for input shape"):
        DetectionServer(model, _cfg(), engine=path, batch_size=4)
    with pytest.raises(ValueError, match="buckets"):
        DetectionServer(model, _cfg(), engine=path, batch_size=2,
                        buckets=(32, 64))
    srv = DetectionServer(model, _cfg(), engine=path, batch_size=2,
                          max_wait_ms=20.0, score_threshold=0.0)
    canvases = _canvases(3, seed=9)
    outs = _http_answers(srv, canvases)
    _assert_answers(outs, canvases,
                    lambda b: detjax_torch.detect_u8(model, b, _cfg()), 2)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detjax_torch.build_model(_cfg(), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detjax_torch.build_model(_cfg(), seed=0, device="cuda")
    assert next(detjax_torch.build_model(
        _cfg(), device="cpu").parameters()).device.type == "cpu"


def _port_files():
    files = sorted((REPO / "detjax_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_never_imports_jax_or_detjax():
    files = _port_files()
    assert len(files) > 15
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"detjax_torch/quant.py", "detjax_torch/export.py",
            "detjax_torch/kernels/ops.py", "detjax_torch/cli/export.py",
            "detjax_torch/cli/serve.py", "detjax_torch/cli/detect.py",
            "detjax_torch/cli/evaluate.py",
            "detjax_torch/utils/visualize.py",
            "detjax_torch/parallel/__init__.py",
            "detjax_torch/parallel/mesh.py",
            "detjax_torch/models/spatial.py"} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "detjax"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_chip_smoke_fails_without_a_gpu_or_outside_the_repo(tmp_path):
    """No CUDA device: non-zero exit and no result line; alone in a
    directory it cannot import the port either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout

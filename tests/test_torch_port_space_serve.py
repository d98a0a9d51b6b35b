"""The port's serving and evaluation over a single-process ``(data, space)``
mesh against detjax's over its spatial mesh, on the CPU.

``make_mesh(["cpu"] * 2, spatial=2)`` splits each image's rows over two
shard threads of one process (``parallel/mesh.py::RowRunner``, exchanging
through ``models/spatial.py::LocalGroup``); detjax's ``make_mesh(spatial=2)``
is a (4, 2) mesh of conftest's eight virtual CPU devices. The weights are
detjax's, carried by ``from_jax``: R18, FPN and head width 32, fp32, the
class output perturbed so that a sparse set of scores clears the floor
(the recipe of ``tests/test_torch_port_eval.py``). Canvases are 64 x 64
(the layout rule gathers every level: P7 is one row) and 512 x 64 (P7 is
four rows, two a shard: the heads run on the shards' rows).

Bars, each stated where it is used:
- the port's split route against detjax's (a server, the evaluation):
  the detect bars of ``tests/test_torch_e2e.py``, keep-sets identical,
  scores 2e-5, boxes 5e-3; the 12 COCO stats within detjax's own 1e-6
  (``tests/test_parallel.py:284-293``);
- the port's split route against its unsplit one in fp32: keep-sets
  identical, scores 1e-6, boxes 1e-4 (``tests/test_torch_port_parallel.py``'s
  bars for a route that differs in conv shapes only); the stats 1e-6;
- int8: every int32 conv sum and every detection bit-equal to the
  unsplit engine's (integer sums are exact, and the bf16 steps between
  them are elementwise);
- int8 against detjax's int8 over its spatial mesh on detjax's qtree,
  compiled without XLA's excess precision (``tests/test_torch_port_quant.py``):
  the detect bars.
"""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from detjax import modeling as jmodeling
from detjax import quant as jquant
from detjax.config import get_config as j_get_config
from detjax.data import SyntheticDetectionDataset as JSynthetic
from detjax.evaluation import evaluator as j_evaluator
from detjax.parallel import make_mesh as j_make_mesh
from detjax.parallel.mesh import _mesh_context
from detjax.serve import DetectionServer as JServer
from detjax.utils.torch_import import (
    export_full_detector,
    import_detector_into_variables,
)

import detjax_torch
from detjax_torch import quant as tquant
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.evaluation import evaluator as t_evaluator
from detjax_torch.models import spatial
from detjax_torch.parallel import make_mesh, replicate
from detjax_torch.parallel.mesh import RowRunner
from detjax_torch.serve import DetectionServer
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

_OVR = {"model.backbone_depth": 18, "model.image_size": (64, 64),
        "model.num_classes": 4, "model.dtype": "float32",
        "model.fpn_channels": 32, "model.head_channels": 32,
        "train.max_gt": 4, "eval.batch_size": 8, "data.host_workers": 2}
TALL = (512, 64)  # P7 has 4 rows: a row-sharded pyramid at S = 2
STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100",
         "ARs", "ARm", "ARl")
EVAL_DS = dict(num_images=8, image_size=(96, 96), num_classes=4,
               max_objects=2, seed=2)
# a shard's wait for its peers in the failure tests, seconds
SHORT_TIMEOUT_S = 1.0


def _configs(**extra):
    ovr = {**_OVR, **extra}
    return (j_get_config("retinanet_r50_640", **ovr),
            detjax_torch.get_config("retinanet_r50_640", **ovr))


@pytest.fixture(scope="module")
def pair():
    """detjax's variables and the port's CPU model on the same weights,
    and 8 seeded canvases of each size."""
    rng = np.random.default_rng(1)
    jcfg, tcfg = _configs()
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(1))
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
    canvases = np.random.default_rng(4).integers(0, 256, (8, 64, 64, 3),
                                                 np.uint8)
    tall = np.random.default_rng(5).integers(0, 256, (2, *TALL, 3),
                                             np.uint8)
    return {"jcfg": jcfg, "tcfg": tcfg, "variables": variables,
            "model": model, "canvases": canvases, "tall": tall}


def _mesh():
    return make_mesh(["cpu"] * 2, spatial=2)


def _slots(det):
    """A Detections batch (torch or jax) as per-slot numpy tuples."""
    return [tuple(np.asarray(t)[i] for t in det[:3])
            + (int(np.asarray(det.num_valid)[i]),)
            for i in range(len(np.asarray(det.num_valid)))]


def _hold(got, want, score_bar, box_bar, min_kept=10):
    """Per slot: the same number kept, the same labels, scores within
    ``score_bar`` and boxes within ``box_bar`` (px)."""
    assert len(got) == len(want)
    for (gb, gs, gl, gn), (wb, ws, wl, wn) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gl[:gn], wl[:wn])
        np.testing.assert_allclose(gs[:gn], ws[:wn], rtol=0, atol=score_bar)
        np.testing.assert_allclose(gb[:gn], wb[:wn], rtol=0, atol=box_bar)
    assert sum(w[3] for w in want) > min_kept, "too few detections"


def _shard_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("detjax-shard")]


# -- serving ---------------------------------------------------------------------

def _png(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _http(srv, canvases):
    """POST each canvas to a running ``srv``, concurrently; the answers."""
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    outs = [None] * len(canvases)
    try:
        assert ready.wait(60)
        base = f"http://127.0.0.1:{srv.port}"

        def hit(i):
            req = urllib.request.Request(f"{base}/detect",
                                         data=_png(canvases[i]),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                outs[i] = json.loads(r.read())["detections"]

        hits = [threading.Thread(target=hit, args=(i,))
                for i in range(len(canvases))]
        for t in hits:
            t.start()
        for t in hits:
            t.join(timeout=60)
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()
    return outs


def test_server_matches_detjax_spatial_server(pair):
    """DetectionServer(mesh=make_mesh(["cpu"] * 2, spatial=2)) answers a
    batch as detjax's DetectionServer(mesh=make_mesh(spatial=2)) does (the
    detect bars) and as the port's unsplit server does (scores 1e-6,
    boxes 1e-4); over HTTP each answer equals the unsplit server's direct
    detect of its canvas within the JSON rounding (scores 1.01e-4, boxes
    1.1e-2 px). Shutdown ends the shard threads."""
    canvases = pair["canvases"]
    jsrv = JServer(pair["variables"], pair["jcfg"], batch_size=8,
                   score_threshold=0.0, mesh=j_make_mesh(spatial=2))
    try:
        want_j = jsrv._runs[0](canvases)
    finally:
        jsrv.shutdown()
    plain = DetectionServer(pair["model"], pair["tcfg"], batch_size=8,
                            score_threshold=0.0)
    split = DetectionServer(pair["model"], pair["tcfg"], batch_size=8,
                            score_threshold=0.0, mesh=_mesh())
    try:
        want = plain._runs[0](canvases)
        got = split._runs[0](canvases)
        assert _shard_threads()
    finally:
        plain.shutdown()
    _hold(got, want, 1e-6, 1e-4)
    _hold(got, want_j, 2e-5, 5e-3)
    outs = _http(split, canvases[:3])
    assert not _shard_threads()
    for i, out in enumerate(outs):
        batch = np.zeros_like(canvases)
        batch[0] = canvases[i]
        b, s, lab, n = _slots(detjax_torch.detect_u8(
            pair["model"], batch, pair["tcfg"]))[0]
        assert [d["label"] for d in out] == lab[:n].tolist()
        np.testing.assert_allclose([d["score"] for d in out],
                                   np.round(s[:n], 4), atol=1.01e-4)
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in out]).reshape(-1, 4),
            np.clip(b[:n], 0, 64), atol=1.1e-2)


def test_row_sharded_pyramid_serves_as_unsplit(pair):
    """At 512 x 64 every level keeps two rows a shard or more, so the
    heads run on the shards' rows and each level's outputs are gathered
    before the flatten (10 gathers a shard: five levels, two towers); the
    answers equal the unsplit server's (scores 1e-6, boxes 1e-4)."""
    _, tcfg = _configs(**{"model.image_size": TALL})
    model = pair["model"]
    plain = DetectionServer(model, tcfg, batch_size=2, score_threshold=0.0)
    split = DetectionServer(model, tcfg, batch_size=2, score_threshold=0.0,
                            mesh=_mesh())
    try:
        want = plain._runs[0](pair["tall"])
        spatial.exchanges.update(dict.fromkeys(spatial.exchanges, 0))
        got = split._runs[0](pair["tall"])
        counts = dict(spatial.exchanges)
    finally:
        plain.shutdown()
        split.shutdown()
    assert spatial.pyramid_sharded(TALL[0], range(3, 8), 2)
    # a halo a shard for: R18's stem conv and pool, its 4 3x3 convs a
    # stage (a strided 1x1 needs none), the FPN's 3 outputs, P6 and P7,
    # and 2 towers x 5 convs x 5 levels
    assert counts == {"halo": 2 * (2 + 16 + 3 + 2 + 50),
                      "halo_grad": 0, "gather": 2 * 10, "gather_grad": 0}
    _hold(got, want, 1e-6, 1e-4)


# -- evaluation ------------------------------------------------------------------

def test_evaluate_matches_detjax_spatial_eval(pair):
    """evaluate(mesh=make_mesh(["cpu"] * 2, spatial=2)) scores the 12 COCO
    stats of detjax's run_coco_eval(mesh=make_mesh(spatial=2)) within 1e-6
    and of the port's unsharded evaluate within 1e-6; each image's
    detections equal the unsharded run's (scores 1e-6, boxes 1e-4)."""
    tcfg, model = pair["tcfg"], pair["model"]
    ds = SyntheticDetectionDataset(**EVAL_DS)
    want_j = j_evaluator.run_coco_eval(
        pair["variables"], JSynthetic(**EVAL_DS), pair["jcfg"],
        mesh=j_make_mesh(spatial=2)).stats
    got = detjax_torch.evaluate(model, ds, tcfg, mesh=_mesh()).stats
    plain = detjax_torch.evaluate(model, ds, tcfg).stats
    for k in STATS:
        assert abs(got[k] - want_j[k]) < 1e-6, (k, got[k], want_j[k])
        assert abs(got[k] - plain[k]) < 1e-6, k
    split = list(t_evaluator.iter_detections(model, ds, tcfg, mesh=_mesh()))
    whole = list(t_evaluator.iter_detections(model, ds, tcfg))
    assert [g[0] for g in split] == [w[0] for w in whole]
    for (_, gb, gs, gl), (_, wb, ws, wl) in zip(split, whole):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
    assert sum(len(w[3]) for w in whole) > 10
    assert not _shard_threads()


# -- int8 ------------------------------------------------------------------------

def _record_int8_sums(monkeypatch):
    """Wrap ``quant.conv_int8``: each thread's int32 outputs in call order,
    with the space index that made them (None on whole rows)."""
    seen = {}
    lock = threading.Lock()
    inner = tquant.conv_int8

    def recording(xq, w, stride=1):
        y = inner(xq, w, stride)
        sg = spatial.active()
        with lock:
            seen.setdefault(threading.get_ident(), []).append(
                (None if sg is None else sg.index, y.clone()))
        return y

    monkeypatch.setattr(tquant, "conv_int8", recording)
    return seen


@pytest.mark.parametrize("hw", [(64, 64), TALL], ids=["gathered", "sharded"])
def test_int8_over_rows_is_bit_equal_to_unsplit(pair, monkeypatch, hw):
    """The int8 server over the space mesh against the unsplit int8
    server, calibrated alike on whole images: every int32 conv sum
    (the shards' rows in order, or each shard's whole rows after a
    gather) and every detection bit-equal."""
    _, tcfg = _configs(**{"model.image_size": hw})
    canvases = pair["canvases"] if hw == (64, 64) else pair["tall"]
    calib = np.random.default_rng(6).integers(0, 256, (2, *hw, 3), np.uint8)
    kw = dict(engine="int8", calibration=calib, score_threshold=0.0,
              batch_size=len(canvases))
    plain = DetectionServer(pair["model"], tcfg, **kw)
    split = DetectionServer(pair["model"], tcfg, mesh=_mesh(), **kw)
    seen = _record_int8_sums(monkeypatch)
    try:
        want = plain._runs[0](canvases)
        (whole,) = seen.values()
        seen.clear()
        got = split._runs[0](canvases)
    finally:
        plain.shutdown()
        split.shutdown()
    shards = sorted(seen.values(), key=lambda calls: calls[0][0])
    assert len(shards) == 2 and len(whole) > 20
    assert [len(s) for s in shards] == [len(whole)] * 2
    row_sharded = 0
    for i, (_, y) in enumerate(whole):
        (i0, y0), (i1, y1) = shards[0][i], shards[1][i]
        if i0 is None:  # whole rows on both shards, after a gather
            assert torch.equal(y0, y) and torch.equal(y1, y)
        else:
            row_sharded += 1
            assert (i0, i1) == (0, 1)
            assert torch.equal(torch.cat([y0, y1], 1), y)
    assert row_sharded > 10
    for (gb, gs, gl, gn), (wb, ws, wl, wn) in zip(got, want):
        assert gn == wn
        for g, w in ((gb, wb), (gs, ws), (gl, wl)):
            np.testing.assert_array_equal(g, w)
    assert sum(w[3] for w in want) > 10


def _port_qtree(jtree):
    """detjax's qtree as the port's: torch tensors, bf16 by bit pattern."""
    def tensor(key, a):
        a = np.asarray(a)
        if key == "w16":
            return torch.from_numpy(np.array(a).view(np.uint16).view(
                np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return {"weights": {p: {k: tensor(k, a) for k, a in node.items()}
                        for p, node in jtree["weights"].items()},
            "act_scales": {k: torch.tensor(np.float32(a))
                           for k, a in jtree["act_scales"].items()}}


def test_int8_over_rows_matches_detjax_spatial_int8(pair):
    """On detjax's qtree, the port's int8 engine over the space mesh (the
    server's RowRunner) keeps the detections of detjax's int8 engine over
    its spatial mesh (``P('data', 'space')``, compiled without excess
    precision): the detect bars."""
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    canvases = pair["canvases"]
    calib = jnp.asarray(np.random.default_rng(6).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    jtree = jquant.quantize(pair["variables"], jcfg, jquant.calibrate(
        pair["variables"], jcfg, calib))
    mesh = j_make_mesh(spatial=2)
    x = jax.device_put(canvases, NamedSharding(mesh, P("data", "space")))
    jtree_r = jax.device_put(jtree, NamedSharding(mesh, P()))
    run = jquant._detect_int8_u8_fn(jcfg)
    with _mesh_context(mesh)():
        want = jax.device_get(jax.jit(run).lower(jtree_r, x).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                jtree_r, x))
    qtree = _port_qtree(jtree)
    runner = RowRunner(torch.device("cpu"), _mesh(),
                       lambda q, c: tquant.detect_int8_u8(q, c, tcfg),
                       replicate(qtree, _mesh()))
    try:
        got = _slots(runner(canvases))
    finally:
        runner.close()
    _hold(got, _slots(want), 2e-5, 5e-3)


# -- failures --------------------------------------------------------------------

def test_a_failing_shard_fails_its_batch_and_the_server_goes_on(
        pair, monkeypatch):
    """A shard that raises at its first exchange aborts its group: its
    peer raises ShardAborted instead of waiting, the batch's request gets
    the shard's own error within the timeout, and the next request is
    answered as the unsplit server answers it (scores 1e-6, boxes
    1e-4)."""
    inner = spatial._all_gather
    failed = []

    def first_gather_of_shard_1_fails(t, sg):
        if sg.index == 1 and not failed:
            failed.append(True)
            raise RuntimeError("injected shard failure")
        return inner(t, sg)

    canvases = pair["canvases"]
    split = DetectionServer(pair["model"], pair["tcfg"], batch_size=8,
                            score_threshold=0.0, mesh=_mesh())
    plain = DetectionServer(pair["model"], pair["tcfg"], batch_size=8,
                            score_threshold=0.0)
    monkeypatch.setattr(spatial, "_all_gather", first_gather_of_shard_1_fails)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="injected shard failure"):
            split.batcher.submit(canvases[0])
        assert time.monotonic() - t0 < spatial.SHARD_TIMEOUT_S
        got = split._runs[0](canvases)
        want = plain._runs[0](canvases)
    finally:
        split.shutdown()
        plain.shutdown()
    assert failed
    _hold(got, want, 1e-6, 1e-4)
    assert not _shard_threads()


def test_a_stalled_shard_times_out_its_peers(monkeypatch):
    """A shard that does not reach its exchange within the timeout: its
    peer raises ShardAborted at the timeout, the call raises TimeoutError
    within it, and once the stalled shard wakes it raises too (the
    group's barrier stays broken) and close() ends every shard thread."""
    mesh = _mesh()
    peers = []

    def fn(_, block):
        if spatial.active().index == 1:
            time.sleep(3 * SHORT_TIMEOUT_S)
        try:
            return spatial.halo(torch.as_tensor(block).permute(0, 3, 1, 2),
                                1, 1)
        except spatial.ShardAborted as e:
            peers.append(e)
            raise

    monkeypatch.setattr(spatial, "SHARD_TIMEOUT_S", SHORT_TIMEOUT_S)
    runner = RowRunner(torch.device("cpu"), mesh, fn, [None, None])
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        runner(np.zeros((2, 64, 8, 3), np.uint8))
    assert time.monotonic() - t0 < 2 * SHORT_TIMEOUT_S
    runner.close()
    assert len(peers) == 2 and not _shard_threads()


# -- the int8 ops and the transport ----------------------------------------------

def _on_shards(fn, x, size, dim=1):
    """``fn(block)`` on ``size`` threads under one LocalGroup, each on its
    block of x's rows (dim ``dim``); the blocks' results."""
    group = spatial.LocalGroup(size)
    h = x.shape[dim] // size
    out, errors = [None] * size, []

    def run(i):
        try:
            with spatial.space_group(spatial.SpaceGroup(group, i, size)):
                out[i] = fn(x.narrow(dim, i * h, h))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            group.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return out


_INT8_OPS = {f"conv{k}_s{s}_{impl}": (k, s, impl)
             for k in (1, 3) for s in (1, 2)
             for impl in ("conv_int8", "conv_int8_reference")}
_INT8_OPS["max_pool_int8"] = (3, 2, "max_pool_int8")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("op", sorted(_INT8_OPS))
def test_int8_ops_on_row_shards_equal_the_whole_image(op, size):
    """conv_int8 (k = 1, 3; stride 1, 2), its plain version and the int8
    max-pool on S row shards of an NHWC int8 image, through the local
    transport, equal the op on the whole image exactly (the shards'
    output rows in order)."""
    k, s, impl = _INT8_OPS[op]
    g = torch.Generator().manual_seed(size * 10 + k + s)
    x = torch.randint(-127, 128, (2, 8 * size, 12, 16), generator=g,
                      dtype=torch.int8)
    if impl == "max_pool_int8":
        def fn(t):
            return tquant.max_pool_int8(t)
    else:
        w = torch.randint(-127, 128, (k, k, 16, 24), generator=g,
                          dtype=torch.int8)

        def fn(t):
            return getattr(tquant, impl)(t, w, s)
    whole = fn(x)
    parts = _on_shards(fn, x, size)
    assert torch.equal(torch.cat(parts, 1), whole)


def test_local_transport_counts_and_gathers_under_threads():
    """Four shard threads exchanging at once: the halo counter counts every
    exchange exactly, and the local all-gather gives every shard every
    shard's block in shard order."""
    spatial.exchanges.update(dict.fromkeys(spatial.exchanges, 0))
    x = torch.arange(4 * 16, dtype=torch.float32).reshape(1, 1, 16, 4)

    def fn(t):
        for _ in range(50):
            spatial.halo(t, 1, 1)
        return torch.cat(spatial._all_gather(t, spatial.active()), 2)

    gathered = _on_shards(fn, x, 4, dim=2)
    assert spatial.exchanges["halo"] == 200
    assert all(torch.equal(t, x) for t in gathered)

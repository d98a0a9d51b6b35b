"""The port's int8 PTQ engine (``detjax_torch/quant.py``) against detjax's
(``detjax/quant.py``) on the same weights, on the CPU: the qtree bit-equal
key for key, ``conv_int8`` and the int8 max-pool bit-equal to detjax's lax
ops, calibration within a stated bar, the int8 forward fed detjax's own
qtree within a tenth of detjax's int8-vs-fp bars, and detect's contract.

One module fixture builds detjax variables with non-trivial BatchNorm
statistics (R18 at 128 px, widths 32, fp32) and the port's model on them.

detjax's jitted int8 engine is compiled here with XLA's
``xla_allow_excess_precision`` off (:func:`exact_jit`): with it on (XLA's
default) a fusion may keep a bf16 intermediate in fp32, and detjax's
jitted forward then differs from its own op-by-op forward in about 29 %
of the logits by one bf16 step at this size; with it off the port's int8
forward equals detjax's bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax

from detjax import modeling as jmodeling
from detjax import quant as jquant
from detjax.config import get_config as j_get_config

import detjax_torch
from detjax_torch import quant as tquant
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

_OVR = {"model.backbone_depth": 18, "model.image_size": (128, 128),
        "model.num_classes": 8, "model.dtype": "float32",
        "model.fpn_channels": 32, "model.head_channels": 32,
        "eval.pre_nms_top_k": 300, "eval.max_detections": 60}


def _perturbed(variables, seed):
    """detjax variables with BatchNorm scales, biases and statistics drawn
    away from identity, so that the fold is not trivial."""
    rng = np.random.default_rng(seed)
    draws = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
             "var": lambda s: rng.uniform(0.5, 2.0, s),
             "mean": lambda s: rng.normal(0, 0.1, s),
             "bias": lambda s: rng.normal(0, 0.1, s)}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (draws[k](v.shape).astype(np.float32) if k in draws
                 else np.asarray(v))
                for k, v in tree.items()}
    host = jax.tree.map(np.asarray, jax.device_get(variables))
    return {"params": walk(host["params"]),
            "batch_stats": walk(host["batch_stats"])}


def _pair(overrides, seed=1, **port_overrides):
    jcfg = j_get_config("retinanet_r50_640", **overrides)
    tcfg = detjax_torch.get_config("retinanet_r50_640",
                                   **{**overrides, **port_overrides})
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(seed))
    variables = _perturbed(variables, seed)
    model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax(variables["params"],
                                   variables["batch_stats"], tcfg.model),
                          strict=True)
    return jcfg, tcfg, variables, model


def exact_jit(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with bf16 intermediates
    rounded where the program rounds them (no excess precision)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _to_jax(model, model_cfg):
    """The port's weights as detjax's variables tree (the inverse of
    ``from_jax``, through the same key maps)."""
    from detjax_torch.models.resnet import RESNET_SPECS
    from detjax_torch.utils.weights import _head_key_map, _resnet_key_map

    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = value
    block, sizes = RESNET_SPECS[model_cfg.backbone_depth]
    for tkey, fpath in _resnet_key_map(sizes, block).items():
        path = ("backbone",) + fpath
        if "bn" in fpath[-1]:
            put(params, path, "scale", sd[f"{tkey}.weight"])
            put(params, path, "bias", sd[f"{tkey}.bias"])
            put(stats, path, "mean", sd[f"{tkey}.running_mean"])
            put(stats, path, "var", sd[f"{tkey}.running_var"])
        else:
            put(params, path, "kernel",
                np.transpose(sd[f"{tkey}.weight"], (2, 3, 1, 0)))
    for tkey, fpath in _head_key_map(
            model_cfg.family, model_cfg.num_head_convs, model_cfg.min_level,
            model_cfg.max_level).items():
        put(params, fpath, "kernel",
            np.transpose(sd[f"{tkey}.weight"], (2, 3, 1, 0)))
        put(params, fpath, "bias", sd[f"{tkey}.bias"])
    return {"params": params, "batch_stats": stats}


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


@pytest.fixture(scope="module")
def r18():
    jcfg, tcfg, variables, model = _pair(_OVR)
    x = np.random.default_rng(3).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    scales = {mode: (jquant.calibrate(variables, jcfg, jnp.asarray(x),
                                      calib_mode=mode),
                     tquant.calibrate(model, tcfg, x, calib_mode=mode))
              for mode in tquant.CALIB_MODES}
    jtree = jquant.quantize(variables, jcfg, scales["absmax"][0])
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, model=model, x=x,
                scales=scales, jtree=jtree)


def _assert_qtree_bit_equal(jtree, ttree):
    assert set(ttree) == {"weights", "act_scales"}
    assert set(ttree["weights"]) == set(jtree["weights"])
    for path, node in jtree["weights"].items():
        got = ttree["weights"][path]
        assert set(got) == set(node), path
        for key, want in node.items():
            want = np.asarray(want)
            have = got[key]
            if key == "w16":
                assert have.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    have.view(torch.int16).numpy(),
                    want.view(np.uint16).view(np.int16), err_msg=path)
            else:
                assert have.numpy().dtype == want.dtype, (path, key)
                np.testing.assert_array_equal(have.numpy(), want,
                                              err_msg=f"{path}/{key}")
    assert set(ttree["act_scales"]) == set(jtree["act_scales"])
    for site, want in jtree["act_scales"].items():
        assert ttree["act_scales"][site].item() == float(want), site


@pytest.mark.parametrize("case", ["r18", "r50", "r18_batch_stats_bn"])
def test_qtree_bit_equal_to_detjax(r18, case):
    """quantize on the same weights and the same activation scales: every
    int8 weight, per-channel scale ws, folded bias b and the stem's bf16
    w16 bit-equal, key for key (exact). R50 holds the bottleneck sites
    (conv3, the projections); a model with batch-statistics BatchNorm folds
    its running statistics the same way."""
    if case == "r18":
        jcfg, tcfg, variables, model = (r18[k] for k in ("jcfg", "tcfg",
                                                         "variables", "model"))
        scales = r18["scales"]["absmax"][0]
    elif case == "r50":  # weights drawn on the port's side, carried over
        over = {**_OVR, "model.backbone_depth": 50}
        jcfg = j_get_config("retinanet_r50_640", **over)
        tcfg = detjax_torch.get_config("retinanet_r50_640", **over)
        model = detjax_torch.build_model(tcfg, seed=2, device="cpu")
        rng = np.random.default_rng(2)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if t.ndim == 1:  # BN affines and statistics
                    t.copy_(torch.from_numpy(rng.uniform(
                        0.5, 1.5, t.shape).astype(np.float32)))
        variables = _to_jax(model, tcfg.model)
        scales = {"backbone/conv1@out": np.float32(0.25)}
    else:  # the fixture's weights in BatchNorm2d modules
        from detjax_torch.models.resnet import BatchNorm2d

        jcfg, variables = r18["jcfg"], r18["variables"]
        tcfg = detjax_torch.get_config(
            "retinanet_r50_640", **_OVR, **{"model.frozen_backbone_bn": False})
        model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
        model.load_state_dict(r18["model"].state_dict(), strict=True)
        assert isinstance(model.bn1, BatchNorm2d)
        scales = r18["scales"]["absmax"][0]
    jtree = jquant.quantize(variables, jcfg, scales)
    _assert_qtree_bit_equal(jtree, tquant.quantize(model, tcfg, scales))


@pytest.mark.parametrize("k,stride,c,n", [
    (1, 1, 64, 64), (3, 1, 32, 48), (3, 2, 64, 40), (1, 2, 32, 64),
    (3, 1, 32, 36),  # N not a multiple of 8 (box_out's 9 x 4)
    (3, 1, 64, 108),  # cls_out's 9 x 12
])
def test_conv_int8_bit_equal_to_detjax(k, stride, c, n):
    """int32 sums exactly equal to detjax's ``_conv(...,
    preferred_element_type=jnp.int32)`` and to the fp64 reference; odd
    sizes so the padding and the stride-2 edge are exercised."""
    rng = np.random.default_rng(k * 100 + stride * 10 + n)
    xq = rng.integers(-127, 128, (2, 9, 11, c), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, c, n), dtype=np.int8)
    want = np.asarray(jquant._conv(jnp.asarray(xq), jnp.asarray(w), stride,
                                   preferred_element_type=jnp.int32))
    got = tquant.conv_int8(torch.from_numpy(xq), torch.from_numpy(w), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tquant.conv_int8_reference(
        torch.from_numpy(xq), torch.from_numpy(w), stride).numpy(), want)


@pytest.mark.parametrize("h,w", [(9, 11), (8, 8), (5, 2)])
def test_max_pool_int8_equals_detjax(h, w):
    """Exactly detjax's ``reduce_window(q, int8(-128), max, 3x3, s2, pad
    1)``, -128 included in the input."""
    q = np.random.default_rng(h * w).integers(-128, 128, (2, h, w, 16),
                                              dtype=np.int8)
    want = np.asarray(lax.reduce_window(
        jnp.asarray(q), jnp.int8(-128), lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        ((0, 0), (1, 1), (1, 1), (0, 0))))
    got = tquant.max_pool_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_percentile_999_matches_numpy():
    """numpy's "linear" 99.9th percentile (of the fp64 values: numpy and
    jnp place the fp32 index in fp32 and miss the interpolation weight)
    within 1e-6 relative."""
    rng = np.random.default_rng(0)
    for n in (1, 7, 1000, 123457):
        a = np.abs(rng.standard_cauchy(n)).astype(np.float32)
        got = tquant.percentile_999(torch.from_numpy(a)).item()
        want = float(np.percentile(a.astype(np.float64), 99.9))
        assert abs(got - want) <= 1e-6 * abs(want), (n, got, want)


@pytest.mark.parametrize("mode", ["absmax", "p999"])
def test_calibrate_matches_detjax(r18, mode):
    """detjax's site keys exactly; each scale within 2.5 % of detjax's,
    most within 1 %. The traversal runs in bf16 on both sides (detjax
    calibrates in bf16 whatever the model dtype), and ATen's and XLA:CPU's
    bf16 convs round differently, a difference that grows with depth."""
    want, got = r18["scales"][mode]
    assert set(got) == set(want)
    assert "head/cls_conv0@p7" in got and "backbone/conv1@out" in got
    rel = np.array([abs(float(got[k]) / float(want[k]) - 1) for k in want])
    assert rel.max() < 2.5e-2, rel.max()
    assert np.median(rel) < 1e-2, np.median(rel)
    assert all(isinstance(v, np.float32) for v in got.values())


def test_calibrate_p999_below_absmax_and_rejects_unknown_modes(r18):
    s_max, s_pct = (r18["scales"][m][1] for m in ("absmax", "p999"))
    assert all(s_pct[k] <= s_max[k] * (1 + 1e-6) for k in s_max)
    assert any(s_pct[k] < 0.97 * s_max[k] for k in s_max)
    with pytest.raises(ValueError, match="calib_mode"):
        tquant.calibrate(r18["model"], r18["tcfg"], r18["x"],
                         calib_mode="minmax")


def test_forward_fp_matches_the_model(r18):
    """The traversal in fp32 equals the model's own forward within 1e-4
    (detjax's bar for its traversal)."""
    model, x = r18["model"], torch.from_numpy(r18["x"])
    got = tquant.forward_fp(model, r18["tcfg"], x, dtype=torch.float32)
    with torch.no_grad():
        want = model(x.permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_forward_int8_on_detjax_qtree_tracks_detjax(r18):
    """The port's int8 forward fed detjax's own qtree against detjax's
    int8 forward: correlation > 0.999 and mean |d| < 0.01, a tenth of
    detjax's int8-vs-fp bars (tests/test_quant.py: 0.99, 0.1)."""
    jtree, x = r18["jtree"], jnp.asarray(r18["x"])
    jcfg = r18["jcfg"]
    want = exact_jit(lambda q, v: jquant.forward_int8(q, jcfg, v), jtree,
                     x)(jtree, x)
    got = tquant.forward_int8(_port_qtree(jtree), r18["tcfg"], r18["x"])
    for g, w in zip(got, want):
        g = g.float().numpy().ravel()
        w = np.asarray(w, np.float32).ravel()
        assert np.corrcoef(g, w)[0, 1] > 0.999
        assert np.abs(g - w).mean() < 0.01


def test_int8_tracks_fp_and_detect_contract(r18):
    """The port's own int8 engine against its fp traversal within detjax's
    bars (corr > 0.99, mean |d| < 0.1); detect_int8 and detect_int8_u8
    keep the Detections contract, and u8 equals detect_int8 on the same
    normalized canvases."""
    model, tcfg = r18["model"], r18["tcfg"]
    canvases = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3),
                                                 np.uint8)
    from detjax_torch.data.pipeline import normalize_u8

    x = normalize_u8(torch.from_numpy(canvases), tcfg.data.mean,
                     tcfg.data.std)
    qtree = detjax_torch.quantize_model(model, tcfg, x)
    fp_cls, _ = tquant.forward_fp(model, tcfg, x, dtype=torch.float32)
    q_cls, _ = tquant.forward_int8(qtree, tcfg, x)
    fp_cls, q_cls = fp_cls.numpy().ravel(), q_cls.float().numpy().ravel()
    assert np.corrcoef(fp_cls, q_cls)[0, 1] > 0.99
    assert np.abs(fp_cls - q_cls).mean() < 0.1

    dets = detjax_torch.detect_int8(qtree, x, tcfg)
    d = tcfg.eval.max_detections
    assert dets.boxes.shape == (2, d, 4) and dets.scores.shape == (2, d)
    assert dets.labels.dtype == torch.int32 and dets.num_valid.shape == (2,)
    assert torch.isfinite(dets.boxes).all()
    assert int(dets.num_valid.min()) > 0
    u8 = detjax_torch.detect_int8_u8(qtree, canvases, tcfg)
    for a, b in zip(u8, dets):
        assert torch.equal(a, b)
    one = detjax_torch.detect_int8(qtree, x[0], tcfg)
    assert one.boxes.shape == (1, d, 4)
    with pytest.raises(TypeError, match="uint8"):
        detjax_torch.detect_int8_u8(qtree, canvases.astype(np.float32), tcfg)


def test_detect_int8_keeps_detjax_detections(r18):
    """detect_int8 on detjax's qtree keeps the detections of detjax's
    jitted int8 engine (``_detect_int8_fn``): the same keep-sets (labels,
    order), scores within 2e-5, boxes within 5e-3
    (tests/test_torch_port_detect.py's bars)."""
    jtree, x = r18["jtree"], jnp.asarray(r18["x"])
    run = jquant._detect_int8_fn(r18["jcfg"])
    want = jax.tree.map(np.asarray, exact_jit(run, jtree, x)(jtree, x))
    got = detjax_torch.detect_int8(_port_qtree(jtree), r18["x"],
                                   r18["tcfg"])
    assert want.num_valid.min() > 10
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                               atol=5e-3)


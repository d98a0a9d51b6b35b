"""PyTorch port vs detjax: the fused identity bottleneck (BN folding, the
kernel's plain twin, and ``model.fused_backbone="on"`` through the whole
detector), on the CPU.

detjax's fused path runs its Pallas kernel in interpret mode here, as its
own tests run it; the port's wrapper runs its plain twin for CPU tensors.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax.config import get_config as j_get_config
from detjax.kernels.bottleneck import (
    _bottleneck_bwd as j_bottleneck_bwd,
    _pick_th as j_pick_th,
    bottleneck_identity as j_bottleneck_identity,
    bottleneck_identity_reference as j_bottleneck_reference,
)
from detjax.modeling import build_model as j_build_model
from detjax.models.detector import build_detector as j_build_detector
from detjax.models.resnet import BottleneckBlock as JBottleneckBlock
from detjax.models.resnet import _fold_bn as j_fold_bn

import detjax_torch
from detjax_torch.kernels import bottleneck as kb
from detjax_torch.models.detector import Detector
from detjax_torch.models.resnet import Bottleneck, ResNet, fold_frozen_bn
from detjax_torch.utils.weights import from_jax

# detjax's own bars for the fused block (tests/test_kernels.py:175-177,
# :218-219): within 5 % of max(|ref|, 1), under 1 % of elements differing
REL_BAR = 0.05
DIFF_FRAC_BAR = 0.01

_SMALL_BF16 = {"model.image_size": (128, 128), "model.num_classes": 6,
               "model.fpn_channels": 32, "model.head_channels": 32,
               "model.dtype": "bfloat16"}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_bars(got: np.ndarray, want: np.ndarray) -> None:
    assert np.abs(got - want).max() <= REL_BAR * max(np.abs(want).max(), 1.0)
    assert (got != want).mean() < DIFF_FRAC_BAR


def _bn_stats(rng, n):
    """Non-identity frozen-BN statistics: scale, bias, mean, var."""
    return (rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, n).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32))


@pytest.mark.parametrize("conv", ["conv1", "conv2", "conv3"])
def test_fold_frozen_bn_bit_equal_to_detjax(conv):
    """(a) The same bf16 weights and fp32 biases as detjax's _fold_bn."""
    rng = np.random.default_rng(1)
    block = Bottleneck(256, 64)
    k, cin, cout = {"conv1": (1, 256, 64), "conv2": (3, 64, 64),
                    "conv3": (1, 64, 256)}[conv]
    hwio = rng.normal(0, (2.0 / (k * k * cin)) ** 0.5,
                      (k, k, cin, cout)).astype(np.float32)
    scale, bias, mean, var = _bn_stats(rng, cout)
    bn = getattr(block, "bn" + conv[-1])
    with torch.no_grad():
        getattr(block, conv).weight.copy_(
            torch.from_numpy(hwio.transpose(3, 2, 0, 1)))
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        w, b = fold_frozen_bn(getattr(block, conv).weight, bn)
    jw, jb = j_fold_bn(jnp.asarray(hwio[0, 0] if k == 1 else hwio),
                       *map(jnp.asarray, (scale, bias, mean, var)))
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert tuple(w.shape) == jw.shape and tuple(b.shape) == jb.shape
    np.testing.assert_array_equal(w.float().numpy(), _np(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def _block_args(seed, b=2, h=32, w=16, c=128):
    """detjax's kernel-test inputs (tests/test_kernels.py:153-165), as
    numpy: x ~ N(0, 1), weights ~ N(0, 0.1), all rounded to bf16."""
    rng = np.random.default_rng(seed)
    m = c // 4

    def bf16(shape, s):
        return _np(jnp.asarray(rng.normal(0, s, shape), jnp.bfloat16))

    return (bf16((b, h, w, c), 1.0), bf16((c, m), 0.1),
            rng.normal(0, 0.1, (1, m)).astype(np.float32),
            bf16((3, 3, m, m), 0.1),
            rng.normal(0, 0.1, (1, m)).astype(np.float32),
            bf16((m, c), 0.1),
            rng.normal(0, 0.1, (1, c)).astype(np.float32))


def _port_twin(args) -> np.ndarray:
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 3, 5):
        t[i] = t[i].to(torch.bfloat16)
    return kb.bottleneck_identity_reference(*t).float().numpy()


def _jax(args):
    return [jnp.asarray(a, jnp.bfloat16) if i in (0, 1, 3, 5)
            else jnp.asarray(a) for i, a in enumerate(args)]


def test_twin_matches_detjax_reference():
    """(b) The twin against detjax's lax oracle: equal except on under 1 %
    of the elements, and there within one bf16 ulp at 1.0 (2^-7), the
    scale of x ~ N(0, 1). fp32 convolutions sum in other orders in oneDNN
    and XLA, which can move a bf16 rounding of y1 or y2 by one ulp; near
    a cancellation of y3 + x that step is several ulps of the (small)
    output itself, so the ulp is taken at the input's scale."""
    args = _block_args(0)
    got = _port_twin(args)
    want = _np(j_bottleneck_reference(*_jax(args)))
    assert got.shape == want.shape == args[0].shape
    assert np.abs(got - want).max() <= 2.0 ** -7
    assert (got != want).mean() < DIFF_FRAC_BAR


def test_twin_matches_detjax_pallas_interpret():
    """(c) The twin against detjax's Pallas kernel in interpret mode, with
    detjax's own bars for kernel vs oracle."""
    args = _block_args(0)
    want = _np(j_bottleneck_identity(*_jax(args), interpret=True))
    _within_bars(_port_twin(args), want)


def test_wrapper_on_cpu_runs_the_twin_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _block_args(3, b=1, h=7, w=16,
                                                      c=64)]
    for i in (0, 1, 3, 5):
        args[i] = args[i].to(torch.bfloat16)
    before = kb.bottleneck_launches
    got = kb.bottleneck_identity(*args)
    assert kb.bottleneck_launches == before
    assert torch.equal(got, kb.bottleneck_identity_reference(*args))
    with pytest.raises(ValueError, match=r"\[1, 16\]|\(1, 16\)"):
        kb.bottleneck_identity(args[0], args[1], args[2][:, :8], *args[3:])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kb.bottleneck_identity(*[a.to("meta") for a in args])


def _perturbed_variables(jcfg, seed):
    """detjax's seeded variables with every BatchNorm's scale, bias, mean
    and var drawn away from identity, so that folding matters."""
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    lo_hi = {"scale": (0.5, 1.5), "var": (0.5, 1.5)}

    def perturb(path, leaf):
        name = getattr(path[-1], "key", "")
        inside_bn = any("bn" in str(getattr(p, "key", "")) for p in path)
        leaf = np.asarray(leaf)
        if not inside_bn or name not in ("scale", "bias", "mean", "var"):
            return leaf
        if name in lo_hi:
            return rng.uniform(*lo_hi[name], leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}))


def _port_features(model, x_nchw):
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16):
        return ResNet.forward(model, x_nchw.to(torch.bfloat16))


@pytest.fixture(scope="module")
def r50_fused():
    """detjax's and the port's R50 detector at 128 px, bf16, narrow heads,
    on the same perturbed weights, both with fused_backbone="on"; detjax's
    C2/C3 features and logits through its Pallas kernel in interpret
    mode."""
    ovr = {**_SMALL_BF16, "model.fused_backbone": "on"}
    jcfg = j_get_config("retinanet_r50_640", **ovr)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **ovr)
    variables = _perturbed_variables(jcfg, 2)
    sd = from_jax(variables["params"], variables["batch_stats"], tcfg.model)
    x = np.random.default_rng(5).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    (j_cls, _), state = j_build_detector(jcfg.model).apply(
        variables, jnp.asarray(x), capture_intermediates=True,
        mutable=["intermediates"])
    j_feats = state["intermediates"]["backbone"]["__call__"][0]
    ref = {"C2": _np(j_feats[2]), "C3": _np(j_feats[3]), "cls": _np(j_cls)}
    return tcfg, sd, x, ref


def _port_outputs(cfg, sd, x, bottleneck_backend="auto"):
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    model.bottleneck_backend = bottleneck_backend
    model.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    feats = _port_features(model, xt)
    with torch.inference_mode():
        cls, _ = model(xt)
    return model, {"C2": feats[2].permute(0, 2, 3, 1).float().numpy(),
                   "C3": feats[3].permute(0, 2, 3, 1).float().numpy(),
                   "cls": cls.float().numpy()}


def _close(got: dict, want: dict) -> None:
    for key in want:
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g - w).max() <= REL_BAR * scale, key


def test_fused_detector_matches_detjax_fused(r50_fused):
    """(d) The port's "on" against detjax's "on" (Pallas in interpret
    mode): C2, C3 and logits within 0.05 x max(|ref|, 1), detjax's drop-in
    bar. bf16 rounds at other places in the two frameworks' unfused blocks
    (BN applied in bf16 here, in flax's order there), so bit-equality is
    not the bar."""
    cfg, sd, x, ref = r50_fused
    model, got = _port_outputs(cfg, sd, x)
    assert len(model.fused_blocks()) == 5
    _close(got, ref)


def test_fused_detector_matches_its_unfused_self(r50_fused):
    """(e) The port's "on" against its own "off" on the same weights, under
    the same bar."""
    cfg, sd, x, _ = r50_fused
    _, on = _port_outputs(cfg, sd, x)
    off_cfg = detjax_torch.get_config("retinanet_r50_640", **_SMALL_BF16)
    _, off = _port_outputs(off_cfg, sd, x)
    _close(on, off)


def test_twin_route_equals_kernel_route_on_the_cpu(r50_fused):
    """On the CPU the "auto" route runs the twin, so the two routes of a
    fused model give equal outputs."""
    cfg, sd, x, _ = r50_fused
    _, auto = _port_outputs(cfg, sd, x)
    model, twin = _port_outputs(cfg, sd, x, bottleneck_backend="torch")
    assert model.bottleneck_backend == "torch"
    assert all(b.fused_backend == "torch" for b in model.fused_blocks())
    for key in auto:
        np.testing.assert_array_equal(auto[key], twin[key], err_msg=key)


def test_fold_is_kept_until_a_weight_changes():
    """The folded weights are made once and reused while nothing changes;
    load_state_dict, an in-place write and a move each make them anew, and
    a call that autograd records folds inside the graph."""
    _, block = kb.seeded_block(0, 1, 4, 16, 16, "cpu")
    with torch.no_grad():
        first = block.folded_weights()
        assert block.folded_weights() is first
        _, other = kb.seeded_block(1, 1, 4, 16, 16, "cpu")
        block.load_state_dict(other.state_dict())
        after_load = block.folded_weights()
        assert after_load is not first
        want = [t for conv, bn in ((other.conv1, other.bn1),
                                   (other.conv2, other.bn2),
                                   (other.conv3, other.bn3))
                for t in fold_frozen_bn(conv.weight, bn)]
        for got, ref in zip(after_load, want):
            assert torch.equal(got, ref)
        block.bn2.running_var.mul_(2.0)
        assert not torch.equal(block.folded_weights()[3], after_load[3])
        block.to(torch.float64)
        assert block.folded_weights()[1].dtype == torch.float32
        assert block.folded_weights()[0].dtype == torch.bfloat16
        block.bn1.bias.add_(0.5)
    with torch.inference_mode():
        cached = block.folded_weights()
    assert not torch.equal(cached[1], after_load[1])
    assert not any(t.is_inference() for t in cached)
    block.float().requires_grad_(True)
    traced = block.folded_weights()
    assert all(t.requires_grad for t in traced)
    assert block.folded_weights() is not traced


def test_fp32_on_is_bit_equal_to_off():
    """(f) With model.dtype="float32", "on" takes no fused route, as in
    detjax (its BottleneckBlock fuses only in bf16)."""
    small = {**_SMALL_BF16, "model.dtype": "float32"}
    on = detjax_torch.build_model("retinanet_r50_640", seed=3, device="cpu",
                                  **small, **{"model.fused_backbone": "on"})
    off = detjax_torch.build_model("retinanet_r50_640", seed=3, device="cpu",
                                   **small)
    assert on.fused_blocks() == []
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (1, 3, 128, 128)).astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(on(x), off(x)):
            assert torch.equal(a, b)


def test_fused_model_takes_the_same_state_dict():
    """(g) "on" changes no parameter: the keys are "off"'s, and
    load_state_dict(strict=True) takes "off"'s state dict."""
    off = detjax_torch.build_model("retinanet_r50_640", seed=1, device="cpu",
                                   **_SMALL_BF16)
    on = detjax_torch.build_model("retinanet_r50_640", seed=2, device="cpu",
                                  **_SMALL_BF16,
                                  **{"model.fused_backbone": "on"})
    assert list(on.state_dict()) == list(off.state_dict())
    on.load_state_dict(off.state_dict(), strict=True)
    for k, v in off.state_dict().items():
        assert torch.equal(on.state_dict()[k], v), k


@pytest.mark.parametrize("depth,want", [
    (50, ["layer1.1", "layer1.2", "layer2.1", "layer2.2", "layer2.3"]),
    (101, ["layer1.1", "layer1.2", "layer2.1", "layer2.2", "layer2.3"]),
    (152, ["layer1.1", "layer1.2"] + [f"layer2.{i}" for i in range(1, 8)]),
    (18, []),
])
def test_fused_blocks_per_depth(depth, want):
    """(h) Stride-1 identity bottlenecks of layer1 and layer2 fuse: five at
    R50 and R101, nine at R152, none in basic-block ResNets."""
    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.backbone_depth": depth, "model.fused_backbone": "on"})
    with torch.device("meta"):
        model = Detector(cfg.model)
    got = [n for n, m in model.named_modules()
           if isinstance(m, Bottleneck) and m.fused]
    assert got == want
    assert len(model.fused_blocks()) == len(want)


# -- the backward ----------------------------------------------------------

# detjax's bar for its backward kernel against autodiff of its oracle
# (tests/test_kernels.py:196-197): max |a - b| < 0.02 * max(|b|, 1e-3)
BWD_BAR = 0.02
BWD_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")


def _bwd_within_bar(got, want, names) -> None:
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= BWD_BAR * max(np.abs(w).max(), 1e-3), \
            name


def _torch_args(args):
    t = [torch.from_numpy(np.array(a)) for a in args]
    for i in (0, 1, 3, 5):
        t[i] = t[i].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("b,h,w,c", [
    (1, 16, 16, 64),  # detjax's own test shape: one row tile
    (2, 64, 32, 64),  # _pick_th gives 32 rows: two row tiles, halo paths
])
def test_backward_twin_matches_detjax_bwd_kernel(b, h, w, c):
    """(i) The backward twin against detjax's _bottleneck_bwd in interpret
    mode, all seven outputs, within detjax's bar. Both round at the same
    places, so they agree far inside it: measured, dx equal to the bit and
    the fp32 sums within 1e-5 of their max (summation order only)."""
    if (b, h) == (2, 64):
        assert h // j_pick_th(h, w, c, backward=True) == 2
    args = _block_args(7, b=b, h=h, w=w, c=c)
    dy = _np(jnp.asarray(np.random.default_rng(8).normal(0, 1, args[0].shape),
                         jnp.bfloat16))
    ja = _jax(args)
    want = j_bottleneck_bwd(ja[0], jnp.asarray(dy, jnp.bfloat16), *ja[1:],
                            interpret=True)
    ta = _torch_args(args)
    got = kb.bottleneck_identity_backward_reference(
        ta[0], torch.from_numpy(np.array(dy)).to(torch.bfloat16), *ta[1:])
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    _bwd_within_bar([g.float().numpy() for g in got],
                    [_np(w).reshape(g.shape) for w, g in zip(want, got)],
                    BWD_NAMES)


def test_autograd_through_wrapper_matches_detjax_grad():
    """(ii) torch.autograd through the port's bottleneck_identity on CPU
    tensors (its backward runs the backward twin) against jax.grad of
    detjax's bottleneck_identity in interpret mode, for sum(out^2), with
    detjax's bar; the gradients come back in the inputs' dtypes."""
    args = _block_args(9, b=1, h=16, w=16, c=64)

    def loss(a):
        return jnp.sum(j_bottleneck_identity(*a, interpret=True).astype(
            jnp.float32) ** 2)

    want = jax.grad(loss)(tuple(_jax(args)))
    leaves = [t.requires_grad_(True) for t in _torch_args(args)]
    before = kb.bottleneck_bwd_launches
    out = kb.bottleneck_identity(*leaves)
    (out.float() ** 2).sum().backward()
    assert kb.bottleneck_bwd_launches == before
    for leaf in leaves:
        assert leaf.grad.dtype == leaf.dtype
    _bwd_within_bar([t.grad.float().numpy() for t in leaves],
                    [_np(w) for w in want], ("x",) + BWD_NAMES[1:])


def test_fused_block_gradients_match_flax_block():
    """(iii) A port Bottleneck(fused=True) with perturbed frozen-BN
    statistics against flax's BottleneckBlock(fused=True), gradients of
    sum(out^2) with respect to x, the three conv kernels and the three BN
    scales and biases, through the fold, within 0.02 x max|ref| (detjax's
    kernel bar): the two frameworks sum fp32 in other orders."""
    rng = np.random.default_rng(11)
    c, m = 64, 16
    x = _np(jnp.asarray(rng.normal(0, 1, (2, 16, 16, c)), jnp.bfloat16))
    convs = {"conv1": (1, 1, c, m), "conv2": (3, 3, m, m),
             "conv3": (1, 1, m, c)}
    params, stats = {}, {}
    for name, shape in convs.items():
        params[name] = {"kernel": rng.normal(
            0, (2.0 / np.prod(shape[:3])) ** 0.5, shape).astype(np.float32)}
        scale, bias, mean, var = _bn_stats(rng, shape[-1])
        bn = "bn" + name[-1]
        params[bn] = {"scale": scale, "bias": bias}
        stats[bn] = {"mean": mean, "var": var}
    jblock = JBottleneckBlock(filters=m, fused=True, dtype=jnp.bfloat16)

    def loss(p, xj):
        out = jblock.apply({"params": p, "batch_stats": stats}, xj)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x, jnp.bfloat16))

    block = Bottleneck(c, m, fused=True).to(memory_format=torch.channels_last)
    with torch.no_grad():
        for name in convs:
            getattr(block, name).weight.copy_(torch.from_numpy(
                params[name]["kernel"].transpose(3, 2, 0, 1)))
            bn = getattr(block, "bn" + name[-1])
            for attr, src in (("weight", params["bn" + name[-1]]["scale"]),
                              ("bias", params["bn" + name[-1]]["bias"]),
                              ("running_mean", stats["bn" + name[-1]]["mean"]),
                              ("running_var", stats["bn" + name[-1]]["var"])):
                getattr(bn, attr).copy_(torch.from_numpy(src))
    xt = torch.from_numpy(np.array(x)).to(torch.bfloat16).permute(0, 3, 1, 2)
    xt.requires_grad_(True)
    (block(xt).float() ** 2).sum().backward()

    got = {"x": xt.grad.permute(0, 2, 3, 1).float().numpy()}
    want = {"x": _np(gx)}
    for name in convs:
        got[name] = getattr(block, name).weight.grad.permute(
            2, 3, 1, 0).numpy()
        want[name] = _np(gp[name]["kernel"])
        bn = "bn" + name[-1]
        got[bn + ".scale"] = getattr(block, bn).weight.grad.numpy()
        want[bn + ".scale"] = _np(gp[bn]["scale"])
        got[bn + ".bias"] = getattr(block, bn).bias.grad.numpy()
        want[bn + ".bias"] = _np(gp[bn]["bias"])
    assert len(got) == 10
    _bwd_within_bar([got[k] for k in want], list(want.values()), list(want))

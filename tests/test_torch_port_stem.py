"""PyTorch port vs detjax: the stem max-pool (3x3, stride 2, pad 1), its
backward's plain twin and the R50-style stem around it, on the CPU.

detjax's ``max_pool_3x3s2`` runs its Pallas backward in interpret mode
here, as its own tests run it; the port's wrapper runs its plain twin for
CPU tensors. Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from detjax.config import get_config as j_get_config
from detjax.kernels.stem import _pick_th as j_pick_th
from detjax.kernels.stem import max_pool_3x3s2 as j_max_pool_3x3s2
from detjax.kernels.stem import (
    max_pool_3x3s2_reference as j_max_pool_3x3s2_reference,
)
from detjax.modeling import build_model as j_build_model

import detjax_torch
from detjax_torch.kernels import stem as ks
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

# NHWC (B, 2H, 2W, C); the last has two of detjax's row tiles
SHAPES = [(2, 16, 16, 4), (2, 16, 24, 8), (1, 128, 128, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns, so that equality also tells -0 from +0."""
    t = t.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _pair(z: np.ndarray, dp: np.ndarray, dtype: str):
    """The same NHWC numpy inputs as detjax arrays and as the port's NCHW
    (channels-last) tensors, rounded once to ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    zj, dpj = jnp.asarray(z, jdt), jnp.asarray(dp, jdt)
    zt, dpt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
               .permute(0, 3, 1, 2) for a in (zj, dpj))
    return zj, dpj, zt, dpt


def _detjax_grad(zj, dpj) -> np.ndarray:
    _, vjp = jax.vjp(j_max_pool_3x3s2, zj)
    return np.asarray(vjp(dpj)[0])


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_two_row_tiles_in_detjax():
    assert j_pick_th(64, 64) == 32  # (1, 128, 128, 8): 64 output rows


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hard", [False, True], ids=["relu", "hard"])
def test_twin_bit_equal_to_detjax_gradient(shape, dtype, hard):
    """The twin against ``jax.vjp`` of detjax's ``max_pool_3x3s2`` (its
    Pallas backward, interpret mode), bit for bit: post-ReLU zeros, and
    with ``hard`` equal maxima, all--inf corner, border and interior
    windows, and NaN."""
    z, dp = ks.seeded_pool_inputs(sum(shape), *shape, hard=hard)
    zj, dpj, zt, dpt = _pair(z, dp, dtype)
    want = _detjax_grad(zj, dpj)
    want = want.view(np.int16 if dtype == "bfloat16" else np.int32)
    got = ks.maxpool_bwd_reference(zt, dpt)
    assert got.dtype == zt.dtype and got.shape == zt.shape
    np.testing.assert_array_equal(_bits(got), want.transpose(0, 3, 1, 2))
    assert bool(zt.isnan().any()) == hard
    assert bool(zt.isinf().any()) == hard


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_bit_equal_to_detjax(dtype):
    z, _ = ks.seeded_pool_inputs(5, 2, 32, 48, 8, hard=True)
    zj, _, zt, _ = _pair(z, z[:, ::2, ::2], dtype)
    want = np.asarray(j_max_pool_3x3s2_reference(zj).astype(jnp.float32))
    got = ks.max_pool_3x3s2_reference(zt).float().permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)  # NaN equal to NaN
    assert np.isnan(want).any() and np.isneginf(want).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_autograd_through_max_pool_3x3s2_equals_twin(dtype):
    """On the CPU the autograd function's backward is the twin, bit for
    bit, in z's layout; its forward is ATen's pool."""
    z, dp = ks.seeded_pool_inputs(9, 2, 16, 24, 8, hard=True)
    _, _, zt, dpt = _pair(z, dp, dtype)
    leaf = zt.detach().requires_grad_(True)
    out = ks.max_pool_3x3s2(leaf)
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        ks.max_pool_3x3s2_reference(zt).float().numpy())
    before = ks.maxpool_bwd_launches
    out.backward(dpt)
    np.testing.assert_array_equal(_bits(leaf.grad),
                                  _bits(ks.maxpool_bwd_reference(zt, dpt)))
    assert leaf.grad.is_contiguous(memory_format=torch.channels_last)
    assert ks.maxpool_bwd_launches == before  # CPU tensors launch nothing


def _aten_grad(zt: torch.Tensor, dpt: torch.Tensor) -> torch.Tensor:
    leaf = zt.detach().requires_grad_(True)
    F.max_pool2d(leaf, 3, stride=2, padding=1).backward(dpt)
    return leaf.grad


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_routes_as_aten_on_post_relu_inputs(shape):
    """On post-ReLU fp32 inputs (exact ties at 0 and in rounded rows) the
    twin routes as ATen's backward does: the same support. ATen sums a
    pixel's (up to 4) windows in the reverse order, so the values differ
    by fp32 rounding of those sums: within 3 eps of the sum of their
    magnitudes (the twin on |dp|). Where dp's terms cancel that is many
    ulps of the result (up to 512 on these draws)."""
    z, dp = ks.seeded_pool_inputs(sum(shape) + 1, *shape)
    z[:, ::3] = np.round(z[:, ::3] * 2) / 2
    zt, dpt = _nchw(z), _nchw(dp)
    got, want = ks.maxpool_bwd_reference(zt, dpt), _aten_grad(zt, dpt)
    np.testing.assert_array_equal(got.numpy() != 0, want.numpy() != 0)
    mag = ks.maxpool_bwd_reference(zt, dpt.abs()).numpy()
    err = np.abs(got.numpy() - want.numpy())
    assert (err <= 3 * np.finfo(np.float32).eps * mag).all()
    assert (err > 0).any()  # the orders do differ on these draws


def test_known_divergences_from_aten():
    """Where detjax's rule and ATen's differ, pinned so that they are
    documented rather than filed as faults: a border window whose real taps
    are all -inf routes nowhere in detjax (its padding tap comes first) and
    to its first in-bounds pixel in ATen; a window holding NaN routes
    nowhere in detjax (no tap equals a NaN max) and to its last NaN in
    ATen."""
    z = np.ones((1, 1, 8, 8), np.float32)
    z[0, 0, 0:2, 0:2] = -np.inf  # window (0, 0): real taps rows/cols 0-1
    z[0, 0, 3, 3] = z[0, 0, 4, 5] = np.nan  # both in window (2, 2)
    dp = np.zeros((1, 1, 4, 4), np.float32)
    dp[0, 0, 0, 0], dp[0, 0, 2, 2] = 3.0, 5.0
    zt, dpt = torch.from_numpy(z), torch.from_numpy(dp)
    got, want = ks.maxpool_bwd_reference(zt, dpt), _aten_grad(zt, dpt)
    assert (got == 0).all()  # both windows route nowhere
    assert want[0, 0, 0, 0] == 3.0  # first in-bounds pixel
    assert want[0, 0, 4, 5] == 5.0 and want[0, 0, 3, 3] == 0  # last NaN
    assert int((want != 0).sum()) == 2
    # and detjax agrees with the twin on both
    zj = jnp.asarray(z.transpose(0, 2, 3, 1))
    dj = _detjax_grad(zj, jnp.asarray(dp.transpose(0, 2, 3, 1)))
    assert (dj == 0).all()


@pytest.mark.parametrize("hz,wz", [(15, 16), (16, 15), (7, 7)])
def test_odd_size_raises(hz, wz):
    z = torch.zeros(1, 2, hz, wz)
    dp = torch.zeros(1, 2, hz // 2, wz // 2)
    for fn in (ks.maxpool_bwd_reference, ks.maxpool_bwd_cuda):
        with pytest.raises(ValueError, match="even"):
            fn(z, dp)
    leaf = z.requires_grad_(True)
    out = ks.max_pool_3x3s2(leaf)
    with pytest.raises(ValueError, match="even"):
        out.backward(torch.ones_like(out))


def test_wrapper_routes_cpu_tensors_to_the_twin():
    z, dp = ks.seeded_pool_inputs(2, 1, 16, 16, 4, hard=True)
    zt, dpt = _nchw(z), _nchw(dp)
    before = ks.maxpool_bwd_launches
    np.testing.assert_array_equal(_bits(ks.maxpool_bwd_cuda(zt, dpt)),
                                  _bits(ks.maxpool_bwd_reference(zt, dpt)))
    assert ks.maxpool_bwd_launches == before
    with pytest.raises(ValueError, match="dp must be"):
        ks.maxpool_bwd_cuda(zt, dpt[:, :, :4])
    with pytest.raises(ValueError, match="one device"):
        ks.maxpool_bwd_cuda(zt, dpt.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ks.maxpool_bwd_cuda(zt.to("meta"), dpt.to("meta"))
    empty = ks.maxpool_bwd_cuda(zt[:0], dpt[:0])
    assert empty.shape == (0, 4, 16, 16)


def _bn_perturbed(variables, rng):
    """detjax's seeded variables with the stem BatchNorm's scale, bias,
    mean and var drawn away from identity."""
    params = jax.tree.map(np.asarray, jax.device_get(variables["params"]))
    stats = jax.tree.map(np.asarray, jax.device_get(variables["batch_stats"]))
    bn_p, bn_s = params["backbone"]["bn1"], stats["backbone"]["bn1"]
    n = bn_p["scale"].shape[0]
    bn_p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bn_p["bias"] = rng.normal(0, 0.3, n).astype(np.float32)
    bn_s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
    bn_s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return params, stats


def test_stem_gradients_match_detjax():
    """The R18 stem at 64 px, fp32: conv1 and bn1 carried over by
    ``from_jax``, then conv (7x7/s2, pad 3) -> frozen BN -> ReLU ->
    ``max_pool_3x3s2``, against detjax's same composition
    (``lax.conv_general_dilated``, flax's frozen-BN arithmetic, its
    ``max_pool_3x3s2``). The pooled output within 1e-6 and the gradients of
    conv1's weight and bn1's scale and bias within 1e-5 of max |detjax|
    (measured: 1.4e-7 and up to 6.6e-7): the convs sum in other orders in
    oneDNN and XLA, and the pool routes the same windows on both."""
    ovr = {"model.backbone_depth": 18, "model.image_size": (64, 64),
           "model.num_classes": 4, "model.fpn_channels": 16,
           "model.head_channels": 16, "model.dtype": "float32"}
    jcfg = j_get_config("retinanet_r50_640", **ovr)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **ovr)
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params, stats = _bn_perturbed(variables, rng)
    model = detjax_torch.build_model(tcfg, seed=1, device="cpu")
    model.load_state_dict(from_jax(params, stats, tcfg.model), strict=True)
    stem = [model.conv1.requires_grad_(True), model.bn1.requires_grad_(True)]
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ct = rng.normal(0, 1, (2, 16, 16, 64)).astype(np.float32)

    kernel = jnp.asarray(params["backbone"]["conv1"]["kernel"])
    bn_p, bn_s = params["backbone"]["bn1"], stats["backbone"]["bn1"]

    def j_stem(kernel, scale, bias):
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x), kernel, (2, 2), ((3, 3), (3, 3)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
        mul = jax.lax.rsqrt(jnp.asarray(bn_s["var"]) + 1e-5) * scale
        y = (y - jnp.asarray(bn_s["mean"])) * mul + bias
        return j_max_pool_3x3s2(jax.nn.relu(y))

    def j_loss(*args):
        return jnp.sum(j_stem(*args) * jnp.asarray(ct))

    j_args = (kernel, jnp.asarray(bn_p["scale"]), jnp.asarray(bn_p["bias"]))
    j_out = np.asarray(j_stem(*j_args))
    j_grads = [np.asarray(g) for g in jax.grad(j_loss, argnums=(0, 1, 2))(
        *j_args)]

    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    z = F.relu(stem[1](stem[0](xt)))
    out = ks.max_pool_3x3s2(z)
    (out * _nchw(ct)).sum().backward()
    t_grads = [model.conv1.weight.grad.permute(2, 3, 1, 0).numpy(),
               model.bn1.weight.grad.numpy(), model.bn1.bias.grad.numpy()]

    got_out = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_out, j_out,
                               atol=1e-6 * np.abs(j_out).max(), rtol=0)
    for name, g, w in zip(("conv1.weight", "bn1.weight", "bn1.bias"),
                          t_grads, j_grads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(),
                                   rtol=0, err_msg=name)

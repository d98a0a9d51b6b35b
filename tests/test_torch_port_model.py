"""PyTorch port vs detjax: the weights carry and the detector forward, on
the CPU at fp32 and small widths."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax.config import get_config as j_get_config
from detjax.modeling import build_model as j_build_model
from detjax.models.detector import build_detector as j_build_detector
from detjax.models.resnet import RESNET_SPECS
from detjax.utils import torch_import

import detjax_torch
from detjax_torch.models.detector import Detector
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

_SMALL = {"model.image_size": (128, 128), "model.num_classes": 6,
          "model.dtype": "float32", "model.fpn_channels": 32,
          "model.head_channels": 32}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=[18, 50])
def carried(request):
    """A detjax detector and the port's, holding the same weights."""
    ovr = {**_SMALL, "model.backbone_depth": request.param}
    jcfg = j_get_config("retinanet_r50_640", **ovr)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **ovr)
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(request.param))
    sd = from_jax(_numpy_tree(variables["params"]),
                  _numpy_tree(variables["batch_stats"]), tcfg.model)
    model = detjax_torch.build_model(tcfg, seed=1, device="cpu")
    model.load_state_dict(sd, strict=True)
    return request.param, jcfg, variables, model, sd


def test_from_jax_equals_export_full_detector(carried):
    depth, _, variables, _, sd = carried
    ref = torch_import.export_full_detector(
        variables["params"], variables["batch_stats"], depth=depth)
    assert sorted(sd) == sorted(ref)
    for key, want in ref.items():
        assert sd[key].dtype == torch.float32, key
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)


def test_forward_matches_detjax(carried):
    """Logits and deltas at fp32 within atol/rtol 5e-4, the bar of the
    torch reference-replica forward test (tests/test_torch_e2e.py)."""
    _, jcfg, variables, model, _ = carried
    x = np.random.default_rng(0).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    j_cls, j_box = j_build_detector(jcfg.model).apply(
        variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_cls, t_box = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_cls.dtype == torch.float32 and t_cls.shape == j_cls.shape
    assert t_box.shape == j_box.shape
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(t_box.numpy(), np.asarray(j_box),
                               atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("depth", sorted(RESNET_SPECS))
def test_state_dict_keys_follow_the_lineage(depth):
    """Every depth's parameter and buffer names are the lineage's, as
    detjax's own key maps spell them."""
    cfg = detjax_torch.get_config("retinanet_r50_640",
                                  **{"model.backbone_depth": depth})
    block, sizes = RESNET_SPECS[depth]
    want = set()
    for prefix, path in torch_import._torch_resnet_key_map(
            sizes, block).items():
        if "bn" in path[-1]:
            want |= {f"{prefix}.{s}" for s in
                     ("weight", "bias", "running_mean", "running_var")}
        else:
            want.add(f"{prefix}.weight")
    for prefix in torch_import._head_key_map("retinanet", 4, 3, 7):
        want |= {f"{prefix}.weight", f"{prefix}.bias"}
    with torch.device("meta"):
        model = Detector(cfg.model)
    assert set(model.state_dict()) == want


def test_seeded_init_is_reproducible_and_prior_biased():
    cfg = detjax_torch.get_config(
        "retinanet_r50_640", **{**_SMALL, "model.backbone_depth": 18,
                                "model.prior_prob": 0.2})
    a = detjax_torch.build_model(cfg, seed=3, device="cpu")
    b = detjax_torch.build_model(cfg, seed=3, device="cpu")
    c = detjax_torch.build_model(cfg, seed=4, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    bias = a.classificationModel.output.bias
    assert torch.allclose(bias, torch.full_like(bias, -math.log(0.8 / 0.2)))
    assert (a.regressionModel.output.bias == 0).all()
    assert (a.layer1[0].bn1.running_var == 1).all()


@pytest.mark.parametrize("knob,value", [
    ("dot_1x1", "dw"), ("remat_early", 2), ("f8_remat_stages", 1),
])
def test_tpu_and_training_knobs_raise(knob, value):
    cfg = detjax_torch.get_config("retinanet_r50_640",
                                  **{f"model.{knob}": value})
    with pytest.raises(NotImplementedError, match="slice"):
        Detector(cfg.model)


def test_fused_backbone_auto_builds_unfused():
    """"auto" means "on a TPU backend only" in detjax: here it builds and
    takes no fused route."""
    cfg = detjax_torch.get_config("retinanet_r50_640",
                                  **{"model.fused_backbone": "auto"})
    with torch.device("meta"):
        model = Detector(cfg.model)
    assert model.fused_blocks() == []
    with pytest.raises(ValueError, match="fused_backbone"):
        Detector(detjax_torch.get_config(
            "retinanet_r50_640", **{"model.fused_backbone": "yes"}).model)


def test_train_state_refuses_fused_backbone():
    """Training with "on" is no longer refused: make_train_state builds the
    five fused blocks of R50 and one CPU train_step (the fused blocks'
    forward and backward twins) moves every trainable tensor, with no
    kernel launch counted."""
    from detjax_torch.kernels import bottleneck as kb

    state = detjax_torch.make_train_state(
        "retinanet_r50_640", device="cpu",
        **{**_SMALL, "model.backbone_depth": 50, "model.dtype": "bfloat16",
           "model.fused_backbone": "on", "train.max_gt": 4})
    assert len(state.model.fused_blocks()) == 5
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 128, 128, 3), np.uint8),
             "gt_boxes": np.tile(np.array([[10, 10, 70, 60]], np.float32),
                                 (2, 4, 1)),
             "gt_labels": np.array([[1, 4, -1, -1]] * 2, np.int32)}
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    launches = (kb.bottleneck_launches, kb.bottleneck_bwd_launches)
    state, metrics = detjax_torch.train_step(state, batch)
    assert (kb.bottleneck_launches, kb.bottleneck_bwd_launches) == launches
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert not [n for n, p in state.model.named_parameters()
                if torch.equal(p, before[n])]


def test_backward_through_fused_block_raises():
    """A backward through the fused block no longer raises: on CPU tensors
    it runs the backward twin, and the gradients autograd hands back equal
    the twin's bit for bit (dx and the folded weights' in bf16, the
    biases' in fp32), with no kernel launch counted."""
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels.bottleneck import bottleneck_identity
    from detjax_torch.models.resnet import Bottleneck

    block = Bottleneck(64, 16, fused=True)
    assert block.fused
    x = torch.randn(1, 64, 4, 16, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    y = block(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    y.float().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is not None for p in block.parameters())

    _, seeded = kb.seeded_block(1, 1, 4, 16, 16, "cpu")
    with torch.no_grad():
        weights = seeded.folded_weights()
    gen = torch.Generator().manual_seed(1)
    xh = torch.randn(1, 4, 16, 64, generator=gen).to(torch.bfloat16)
    dy = torch.randn(1, 4, 16, 64, generator=gen).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (xh, *weights)]
    launches = kb.bottleneck_bwd_launches
    bottleneck_identity(*leaves).backward(dy)
    assert kb.bottleneck_bwd_launches == launches
    want = kb.bottleneck_identity_backward_reference(xh, dy, *weights)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, ref.to(leaf.dtype))


def test_bf16_forward_returns_bf16_with_fp32_params():
    cfg = detjax_torch.get_config(
        "retinanet_r50_640", **{**_SMALL, "model.backbone_depth": 18,
                                "model.dtype": "bfloat16"})
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    x = torch.zeros(1, 3, 128, 128)
    with torch.no_grad():
        cls, box = model(x)
    assert cls.dtype == box.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.isfinite(cls.float()).all()

"""PyTorch port vs detjax end to end: ``detect_u8`` on the same weights and
canvases at fp32, through both candidate-selection branches, on the CPU
(the port's NMS runs as its plain twin there)."""

import numpy as np
import pytest

import jax
import torch

from detjax import modeling as jmodeling
from detjax.config import get_config as j_get_config
from detjax.ops import nms as jnms
from detjax.utils.torch_import import (
    export_full_detector,
    import_detector_into_variables,
)

import detjax_torch
from detjax_torch.ops import nms as tnms
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

_OVR = {"model.backbone_depth": 18, "model.image_size": (128, 128),
        "model.num_classes": 8, "model.dtype": "float32",
        "model.fpn_channels": 32, "model.head_channels": 32,
        "eval.pre_nms_top_k": 300, "eval.max_detections": 60}


@pytest.fixture(scope="module")
def pair():
    """detjax variables and the port's model on the same de-saturated
    weights: the class output is perturbed so that a sparse set of scores
    clears the 0.05 floor without saturating the fp32 sigmoid (the recipe
    of tests/test_torch_e2e.py)."""
    rng = np.random.default_rng(11)
    jcfg = j_get_config("retinanet_r50_640", **_OVR)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **_OVR)
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
    canvases = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    return jcfg, tcfg, variables, model, canvases


@pytest.fixture
def fresh_detjax_jit():
    """detjax caches one compiled detect per config; clear it around a test
    that patches ``_EXACT_PAIRS_MAX`` so the patch is traced in and out."""
    jmodeling._detect_fn.cache_clear()
    jmodeling._detect_u8_fn.cache_clear()
    yield
    jmodeling._detect_fn.cache_clear()
    jmodeling._detect_u8_fn.cache_clear()


@pytest.mark.parametrize("two_stage", [False, True])
def test_detect_u8_matches_detjax(pair, two_stage, monkeypatch,
                                  fresh_detjax_jit):
    """Identical keep-sets (labels and order), scores within atol 2e-5 and
    boxes within atol 5e-3, the bars of tests/test_torch_e2e.py."""
    jcfg, tcfg, variables, model, canvases = pair
    if two_stage:  # a 128 px canvas always takes the exact branch otherwise
        monkeypatch.setattr(jnms, "_EXACT_PAIRS_MAX", 0)
        monkeypatch.setattr(tnms, "_EXACT_PAIRS_MAX", 0)
    want = jax.tree.map(np.asarray, jmodeling.detect_u8(variables, canvases,
                                                        jcfg))
    got = detjax_torch.detect_u8(model, canvases, tcfg)
    assert got.boxes.shape == (2, 60, 4) and got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    assert want.num_valid.min() > 10, "too few detections to be a test"
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores,
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes,
                               rtol=0, atol=5e-3)


def test_detect_equals_detect_u8_on_normalized_input(pair):
    _, tcfg, _, model, canvases = pair
    from detjax_torch.data.pipeline import normalize_u8

    x = normalize_u8(torch.from_numpy(canvases), tcfg.data.mean,
                     tcfg.data.std)
    a = detjax_torch.detect(model, x, tcfg)
    b = detjax_torch.detect_u8(model, canvases, tcfg)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_normalize_u8_matches_detjax():
    from detjax.data.pipeline import normalize_u8 as j_normalize
    from detjax_torch.data.pipeline import normalize_u8 as t_normalize

    u8 = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(
        t_normalize(torch.from_numpy(u8), mean, std).numpy(),
        np.asarray(j_normalize(u8, mean, std)), rtol=0, atol=1e-6)


def test_detect_rejects_a_foreign_config(pair):
    _, tcfg, _, model, canvases = pair
    with pytest.raises(ValueError, match="model section differs"):
        detjax_torch.detect_u8(model, canvases, tcfg.__class__(
            model=tcfg.model.__class__(**{**tcfg.model.__dict__,
                                          "num_classes": 9}),
            train=tcfg.train, data=tcfg.data, eval=tcfg.eval))
    with pytest.raises(TypeError, match="uint8"):
        detjax_torch.detect_u8(model, canvases.astype(np.float32), tcfg)

"""Saved detect programs (``detjax_torch/export.py``) against the port's
live engines and against detjax's own exported artifacts
(``detjax/export.py``) on the same weights, on the CPU.

One module fixture exports, saves and reloads two programs of the port
(the fp engine with uint8 input, the int8 engine with fp32 input, both
R18 at 128 px, widths 32, one conv a head tower, fp32) and detjax's two
counterparts. detjax's
artifacts run compiled with XLA's ``xla_allow_excess_precision`` off
(see tests/test_torch_port_quant.py): with it on, detjax's int8 logits
move by a bf16 step from its own op-by-op forward.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax import export as jexport
from detjax import quant as jquant

import detjax_torch
from detjax_torch import export as texport
from detjax_torch.data.pipeline import normalize_u8

from test_torch_port_detect import _OVR as _DETECT_OVR
from test_torch_port_quant import _port_qtree, exact_jit

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

# tests/test_torch_port_detect.py's config with one conv a head tower: an
# int8 program's trace, save and load take time in proportion to its convs
_OVR = {**_DETECT_OVR, "model.num_head_convs": 1}


def _desaturated_pair():
    """The weights of tests/test_torch_port_detect.py's fixture: detjax's
    R18 with its class output perturbed, so that a sparse set of scores
    clears the 0.05 floor, carried into the port."""
    from detjax import modeling as jmodeling
    from detjax.config import get_config as j_get_config
    from detjax.utils.torch_import import (export_full_detector,
                                           import_detector_into_variables)
    from detjax_torch.utils.weights import from_jax

    rng = np.random.default_rng(11)
    jcfg = j_get_config("retinanet_r50_640", **_OVR)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **_OVR)
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(1))
    sd = dict(export_full_detector(variables["params"],
                                   variables["batch_stats"], depth=18,
                                   num_head_convs=1))
    w = "classificationModel.output.weight"
    b = "classificationModel.output.bias"
    sd[w] = (sd[w] + rng.normal(0, 0.08, sd[w].shape)).astype(np.float32)
    sd[b] = (sd[b] + rng.normal(0, 1.2, sd[b].shape)).astype(np.float32)
    r = "regressionModel.output.weight"
    sd[r] = (sd[r] * 3.0).astype(np.float32)
    variables = import_detector_into_variables(variables, sd, depth=18,
                                               num_head_convs=1)
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax(variables["params"],
                                   variables["batch_stats"], tcfg.model),
                          strict=True)
    canvases = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    return jcfg, tcfg, variables, model, canvases


@pytest.fixture(scope="module")
def progs(tmp_path_factory):
    jcfg, tcfg, variables, model, canvases = _desaturated_pair()
    d = tmp_path_factory.mktemp("programs")
    x = normalize_u8(torch.from_numpy(canvases), tcfg.data.mean,
                     tcfg.data.std)
    jtree = jquant.quantize_model(variables, jcfg, jnp.asarray(x.numpy()))
    qtree = _port_qtree(jtree)
    paths = {"fp_u8": str(d / "fp_u8.pt2"), "int8_fp32": str(d / "int8.pt2")}
    texport.save_detect(paths["fp_u8"], model, tcfg, batch_size=2,
                        input_format="u8")
    texport.save_detect(paths["int8_fp32"], model, tcfg, batch_size=2,
                        qtree=qtree)
    jarts = {
        "fp_u8": jexport.export_detect(variables, jcfg, batch_size=2,
                                       input_format="u8"),
        "int8_fp32": jexport.export_detect(
            variables, jcfg, batch_size=2, calibration=jnp.asarray(x.numpy())),
    }
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, canvases=canvases, x=x,
                qtree=qtree, paths=paths, jarts=jarts,
                runs={k: texport.load_detect(p) for k, p in paths.items()})


def _feed(progs, name):
    return progs["canvases"] if name == "fp_u8" else progs["x"]


def test_programs_equal_the_live_engines(progs):
    """Reloaded, each program equals its live engine bit for bit on the
    CPU (the same ops in the same order): ``detect_u8`` for the fp one,
    ``detect_int8`` on the same qtree for the int8 one."""
    fp = progs["runs"]["fp_u8"](progs["canvases"])
    live = detjax_torch.detect_u8(progs["model"], progs["canvases"],
                                  progs["tcfg"])
    q = progs["runs"]["int8_fp32"](progs["x"])
    live_q = detjax_torch.detect_int8(progs["qtree"], progs["x"],
                                      progs["tcfg"])
    for got, want in ((fp, live), (q, live_q)):
        assert int(want.num_valid.min()) > 10
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["fp_u8", "int8_fp32"])
def test_programs_match_detjax_artifacts(progs, name):
    """The port's program against detjax's artifact on the same weights
    (and, for int8, the same calibration): the same keep-sets (labels,
    order), scores within 2e-5, boxes within 5e-3
    (tests/test_torch_port_detect.py's bars)."""
    feed = _feed(progs, name)
    exp = progs["jarts"][name]
    arg = jnp.asarray(feed if name == "fp_u8" else feed.numpy())
    want = jax.tree.map(np.asarray, exact_jit(exp.call, arg)(arg))
    got = progs["runs"][name](feed)
    assert want.num_valid.min() > 10
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                               atol=5e-3)


def test_input_signature_casting_and_rejection(progs):
    """detjax's rule: a float feed to an fp32 program is cast (bf16 and
    fp64 here); a uint8 program rejects a float feed; another shape
    raises."""
    fp, q = progs["runs"]["fp_u8"], progs["runs"]["int8_fp32"]
    assert fp.in_dtype == torch.uint8 and fp.in_shape == (2, 128, 128, 3)
    assert q.in_dtype == torch.float32 and q.in_shape == (2, 128, 128, 3)
    want = q(progs["x"])
    for a, b in zip(q(progs["x"].double()), want):
        assert torch.equal(a, b)
    bf = progs["x"].to(torch.bfloat16)
    for a, b in zip(q(bf), q(bf.float())):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="uint8"):
        fp(progs["canvases"].astype(np.float32))
    with pytest.raises(TypeError):
        q(progs["canvases"])
    with pytest.raises(ValueError, match="shape"):
        fp(progs["canvases"][:1])


def test_export_arguments_are_checked(progs):
    model, tcfg = progs["model"], progs["tcfg"]
    for platforms in (("tpu",), ("cpu", "cuda")):
        with pytest.raises(ValueError, match="platforms"):
            texport.export_detect(model, tcfg, platforms=platforms)
    with pytest.raises(ValueError, match="input_format"):
        texport.export_detect(model, tcfg, input_format="nv12")
    with pytest.raises(ValueError, match="not both"):
        texport.export_detect(model, tcfg, calibration=progs["x"],
                              qtree=progs["qtree"])


def test_program_loads_without_model_code(progs, tmp_path):
    """A fresh process that imports the custom ops' module and no module
    of ``detjax_torch.models`` loads the program and gets the same
    detections, at this process's CPU thread count (oneDNN's fp32
    convolutions round by their thread split)."""
    np.save(tmp_path / "c.npy", progs["canvases"])
    script = (
        "import sys, numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "import detjax_torch.kernels.ops\n"
        "from detjax_torch.export import load_detect\n"
        f"det = load_detect({progs['paths']['fp_u8']!r})("
        f"np.load({str(tmp_path / 'c.npy')!r}))\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('detjax_torch.models', 'detjax_torch.quant', 'detjax_torch.modeling'"
        ", 'jax', 'detjax.'))]\n"
        "assert not bad, bad\n"
        f"torch.save(tuple(det), {str(tmp_path / 'd.pt')!r})\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = torch.load(tmp_path / "d.pt")
    want = progs["runs"]["fp_u8"](progs["canvases"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_program_calls_the_ops():
    """R50, bf16, ``fused_backbone="on"`` at 64 px (one conv a head
    tower): the program holds five
    ``detjax_torch::bottleneck_identity`` and one ``detjax_torch::nms``
    node, and equals the live ``detect_u8`` bit for bit (on the CPU both
    ops run their plain twins)."""
    over = {"model.backbone_depth": 50, "model.image_size": (64, 64),
            "model.num_classes": 4, "model.fpn_channels": 32,
            "model.head_channels": 32, "model.num_head_convs": 1,
            "model.fused_backbone": "on",
            "model.prior_prob": 0.3, "eval.pre_nms_top_k": 50,
            "eval.max_detections": 10}
    cfg = detjax_torch.get_config("retinanet_r50_640", **over)
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    canvases = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                                 np.uint8)
    prog = detjax_torch.export_detect(model, cfg, batch_size=2,
                                      input_format="u8")
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert targets.count("detjax_torch.bottleneck_identity.default") == 5
    assert targets.count("detjax_torch.nms.default") == 1
    got = prog.module()(torch.from_numpy(canvases))
    want = detjax_torch.detect_u8(model, canvases, cfg)
    assert int(want.num_valid.min()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)

"""The port's export, serve, detect and evaluate CLIs
(``python -m detjax_torch.cli.<name>``), each run once on the CPU on a
tiny checkpoint that ``detjax_torch.cli.train`` writes (R18 at 64 px,
widths 32, one conv a head tower, fp32, one step)."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from detjax_torch.cli import detect as cli_detect
from detjax_torch.cli import evaluate as cli_evaluate
from detjax_torch.cli import export as cli_export
from detjax_torch.cli import serve as cli_serve
from detjax_torch.cli import train as cli_train

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

_SETS = ["model.image_size=(64,64)", "model.dtype=float32",
         "model.backbone_depth=18", "model.fpn_channels=32",
         "model.head_channels=32", "model.num_head_convs=1",
         "model.num_classes=8"]


def _sets():
    return [a for s in _SETS for a in ("--set", s)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A one-step checkpoint and three PNG images."""
    from PIL import Image

    d = tmp_path_factory.mktemp("cli")
    ckpt = d / "ckpt"
    cli_train.main(["--synthetic", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(ckpt)] + _sets())
    rng = np.random.default_rng(0)
    images = []
    for i, hw in enumerate(((50, 70), (64, 64), (90, 40))):
        path = d / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(path)
        images.append(str(path))
    return {"dir": d, "ckpt": str(ckpt), "images": images}


def _common(run):
    return ["--ckpt-dir", run["ckpt"], "--device", "cpu"] + _sets()


@pytest.mark.parametrize("engine", ["fp_u8", "int8_fp32"])
def test_export_cli_selftest_passes(run, engine, capsys):
    """``export --selftest`` writes the program, reloads it and holds it
    to the live engine (counts within 1, scores within 2e-2)."""
    out = str(run["dir"] / f"{engine}.pt2")
    argv = [out, "--batch-size", "2", "--selftest"] + _common(run)
    if engine == "fp_u8":
        argv += ["--input", "u8"]
    else:
        argv += ["--int8-calibrate"] + run["images"]
    cli_export.main(argv)
    text = capsys.readouterr().out
    assert "selftest" in text and "-> OK" in text
    from detjax_torch.export import load_detect

    prog = load_detect(out)
    assert prog.in_shape == (2, 64, 64, 3)
    assert prog.in_dtype == (torch.uint8 if engine == "fp_u8"
                             else torch.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_detect_cli_writes_annotated_images(run, int8):
    out_dir = run["dir"] / f"det_{int8}"
    argv = run["images"] + ["--out-dir", str(out_dir),
                            "--score-threshold", "0.0"] + _common(run)
    written = cli_detect.main(argv + (["--int8"] if int8 else []))
    from PIL import Image

    assert len(written) == 3
    for src, dst in zip(run["images"], written):
        assert Image.open(dst).size == Image.open(src).size


@pytest.mark.parametrize("int8", [False, True])
def test_evaluate_cli_prints_coco_stats(run, int8, capsys):
    argv = ["--synthetic", "--max-images", "8"] + _common(run)
    res = cli_evaluate.main(argv + (["--int8"] if int8 else []))
    assert len(res.stats) == 12
    assert "AP50" in capsys.readouterr().out


def test_serve_cli_answers_with_the_int8_engine(run):
    """``serve --engine int8 --int8-calibrate ...``: the server the CLI
    builds answers /healthz and a POST /detect; without calibration images
    the CLI refuses int8."""
    ap = cli_serve.build_parser()
    with pytest.raises(SystemExit):
        cli_serve.make_server(ap.parse_args(
            ["--engine", "int8"] + _common(run)), ap)
    args = ap.parse_args(["--engine", "int8", "--batch-size", "2",
                          "--int8-calibrate"] + run["images"] + _common(run))
    _, srv = cli_serve.make_server(args, ap)
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    try:
        assert ready.wait(120)
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["engine"] == "int8" and health["batch_size"] == 2
        with open(run["images"][0], "rb") as f:
            req = urllib.request.Request(f"{base}/detect", data=f.read())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert "detections" in json.loads(r.read())
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()

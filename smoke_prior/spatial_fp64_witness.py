"""Whether the port's fp32 step misses detjax's by rounding or by a fault,
at the two spatial-test cases where it misses the one-step bar: a witness
in fp64, on the CPU.

``tests/test_torch_port_spatial.py`` runs detjax's single-device step and
the port's, from the same weights and batch, at 512 px (R18, 2 images,
frozen BN) and at 128 px with batch statistics (4 images). There the
port's fp32 gradients miss detjax's fp32 gradients by 5x and 131x the
elementwise bar (2e-3 relative plus 1e-4 of the tensor's largest). This
script takes the same two steps three ways: detjax in fp32, the port in
fp32, and the port in fp64 (a second process of this script aliases
``torch.float32`` to ``torch.float64`` before the port is imported, so
every fp32 cast in the port is an fp64 one, and turns the model to fp64).
The fp64 gradient stands in for the exact gradient of the port's
function. If detjax's fp32 gradient is as near to it as the port's fp32
gradient is, the two sides compute one function and the gap between them
is fp32 rounding. It prints one JSON line a case: for each pair of the
three, the largest 2-norm gap over the 96 tensors (||a - b|| / ||b||) and
the largest elementwise gap in units of the bar, with the tensors that
give them, and the dtypes of the fp64 side's gradients.

    JAX_PLATFORMS=cpu PYTHONPATH=. python smoke_prior/spatial_fp64_witness.py
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "tests"), str(REPO)]
CASES = ("frozen_512", "bn_128")

if "--fp64" in sys.argv:
    import torch

    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)
else:
    import conftest  # noqa: F401  (jax on conftest's virtual CPU devices)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import detjax_torch  # noqa: E402
import test_torch_port_spatial as T  # noqa: E402
from detjax_torch.train import step as tstep  # noqa: E402


def port_step(name: str, sd: dict, fp64: bool) -> dict:
    state = detjax_torch.make_train_state(T._cfg(name), seed=5, device="cpu")
    state.model.load_state_dict(sd, strict=True)
    batch = T._batch(*T.STEPS[name][:2])
    if fp64:
        state.model.double()
        batch["images"] = batch["images"].astype(np.float64)
    state, _ = tstep.train_step(state, batch)
    return {n: p.grad.detach().clone()
            for n, p in state.model.named_parameters()}


def gaps(a: dict, b: dict) -> dict:
    """Largest 2-norm gap and largest elementwise gap in bars, a against b,
    over the parameters (``a``'s keys)."""
    norm, elem = (0.0, ""), (0.0, "")
    for n in a:
        x, y = a[n].double().numpy(), b[n].double().numpy()
        r = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-300))
        e = float((np.abs(x - y) / T._bar(y)).max())
        norm, elem = max(norm, (r, n)), max(elem, (e, n))
    return {"norm": norm[0], "norm_tensor": norm[1],
            "bars": elem[0], "bars_tensor": elem[1]}


def main() -> None:
    torch.set_num_threads(8)
    if "--fp64" in sys.argv:
        tmp = Path(sys.argv[-1])
        sd = torch.load(tmp / "sd.pt", weights_only=False)
        torch.save({n: port_step(n, sd, True) for n in CASES},
                   tmp / "port64.pt")
        return
    from detjax_torch.utils.weights import from_jax

    mcfg = T._cfg("frozen_128").model
    jax = dict(T._jax_steps())
    sd = from_jax(*jax["weights"], mcfg)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(sd, Path(tmp) / "sd.pt")
        subprocess.run([sys.executable, __file__, "--fp64", tmp], check=True)
        port64 = torch.load(Path(tmp) / "port64.pt", weights_only=False)
    for name in CASES:
        j32 = from_jax(jax[name][1], jax[name][2], mcfg)
        p32 = port_step(name, sd, False)
        p64 = port64[name]
        print(json.dumps({
            "case": name,
            "fp64_dtypes": sorted({str(v.dtype) for v in p64.values()}),
            "tensors": len(p32),
            "port32_vs_port64": gaps(p32, p64),
            "detjax32_vs_port64": gaps({n: j32[n] for n in p32}, p64),
            "port32_vs_detjax32": gaps(p32, j32)}), flush=True)


if __name__ == "__main__":
    main()

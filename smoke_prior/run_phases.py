"""Run chosen phases of chip_smoke.py, in the order given, on the card:

    python3 smoke_prior/run_phases.py build bottleneck_kernel space_serve

``build`` builds every kernel first (one nvcc a source, all at once). The
kernel entries of the report start empty, so a phase that adds to an
earlier phase's entry runs alone. Prints the phases' JSON lines, each
phase's wall time and the kernels line; exits non-zero if a phase fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

KERNELS = ("nms_cuda", "match_iou_cuda", "bottleneck_identity_cuda",
           "bottleneck_identity_bwd_cuda", "decode_boxes_cuda")
STATE_ONLY = ("serve", "bench", "data", "evaluate_protocol")


def main(names) -> None:
    import torch

    report = {k: {"name": k} for k in KERNELS}
    state = {"card": cs.print_card()}
    for name in names:
        t0 = time.perf_counter()
        if name == "build":
            cs.phase_build()
        elif name in STATE_ONLY:
            getattr(cs, f"phase_{name}")(state)
        elif name.endswith("_kernel"):
            getattr(cs, f"phase_{name}")(report)
        else:
            getattr(cs, f"phase_{name}")(report, state)
        cs.emit({"phase_wall_s": name, "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    cs.emit({"kernels": list(report.values())})


if __name__ == "__main__":
    main(sys.argv[1:])

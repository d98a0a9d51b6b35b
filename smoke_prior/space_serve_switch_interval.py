"""One split batch's host time against the interpreter's switch interval:
retinanet_r50_1024 ("off", bs 8, bf16, chip_smoke.py's seeded desaturated
weights) through ``DetectionServer`` on the single-process (1 x 2) space
mesh at switch intervals of the default (5 ms), 1 ms, 0.1 ms and 10 us,
and the server with no mesh, in turns over three rounds. Prints one JSON
line of ms lists.

    python3 smoke_prior/space_serve_switch_interval.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import detjax_torch
    from detjax_torch.parallel import make_mesh
    from detjax_torch.serve import DetectionServer

    cs.print_card()
    cfg = cs.space_serve_config("retinanet_r50_1024")
    model = detjax_torch.build_model(cfg, seed=0)
    canvases = cs.seeded_canvases(11, 8, cfg.model.image_size)
    cs.desaturate_(model, canvases[:4], cfg)
    mesh = make_mesh(["cuda:0", "cuda:0"], spatial=2)
    kw = dict(batch_size=8, score_threshold=0.0)
    plain = DetectionServer(model, cfg, **kw)
    split = DetectionServer(model, cfg, mesh=mesh, **kw)
    default = sys.getswitchinterval()
    ms: dict = {}

    def timed(key, srv):
        t0 = time.perf_counter()
        srv._runs[0](canvases)
        ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)

    try:
        for srv in (plain, split):
            srv.warmup()
            srv._runs[0](canvases)
        for _ in range(3):
            for interval in (default, 1e-3, 1e-4, 1e-5):
                sys.setswitchinterval(interval)
                timed(f"split_si_{interval}", split)
            sys.setswitchinterval(default)
            timed("unsplit", plain)
    finally:
        sys.setswitchinterval(default)
        plain.shutdown()
        split.shutdown()
    print(json.dumps({"probe": "switch_interval", "default_s": default,
                      "ms": ms}))


if __name__ == "__main__":
    main()

"""Where one batch's time goes on the single-process (1 x 2) space mesh:
torch.profiler over one batch of retinanet_r50_1024 ("off", bs 8, bf16,
chip_smoke.py's seeded desaturated weights) through
``DetectionServer(mesh=make_mesh(["cuda:0", "cuda:0"], spatial=2))`` and
through the server with no mesh. Prints a JSON line a route: the wall
time, the device's busy time, and the top device kernels and host ops.

    python3 smoke_prior/space_serve_profile.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

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
    servers = {"unsplit": DetectionServer(model, cfg, **kw),
               "split": DetectionServer(model, cfg, mesh=mesh, **kw)}
    try:
        for srv in servers.values():
            srv.warmup()
            srv._runs[0](canvases)
        for name, srv in servers.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                srv._runs[0](canvases)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = cs.device_events(prof)
            by_name: dict = {}
            for n, t in events:
                by_name[n[:90]] = by_name.get(n[:90], 0.0) + t
            host = sorted(((e.key, e.cpu_time_total / 1e3, e.count)
                           for e in prof.key_averages()),
                          key=lambda r: -r[1])[:25]
            print(json.dumps({
                "route": name, "wall_ms": wall,
                "device_busy_ms": sum(t for _, t in events),
                "events": len(events),
                "top_device": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:12],
                "top_host": host}))
    finally:
        for srv in servers.values():
            srv.shutdown()


if __name__ == "__main__":
    main()

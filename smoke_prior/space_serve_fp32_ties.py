"""fp32 retinanet_r50_1024 (TF32 off, bs 8, chip_smoke.py's seeded
desaturated weights, canvas seed 15) on the single-process (1 x 2) space
mesh against no mesh: where the split head outputs differ, and why the
detections differ.

Prints one JSON line of the head outputs through a ``RowRunner`` against
the model's own (each route run twice: is it deterministic?; the TF32 and
cuDNN flags seen on the shard threads; for each level, classes and boxes,
the largest difference, the largest value, and the four rows of the
level with the largest differences), one line on whether each server
repeats itself bit for bit, and a line a slot: the positions whose boxes
differ by more than 5e-3 px, each with both routes' (score, label, box),
where the split route's box sits among the unsplit route's detections,
and the unsplit route's scores around it.

    python3 smoke_prior/space_serve_fp32_ties.py [preset] [dtype]
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

Heads = collections.namedtuple("Heads", "cls box")


def level_gaps(got, want, cfg) -> dict:
    m = cfg.model
    out, start = {}, 0
    for lvl, n in zip(range(m.min_level, m.max_level + 1),
                      cs.level_rows(cfg)):
        rows = -(-m.image_size[0] // 2**lvl)
        d = (got[:, start:start + n] - want[:, start:start + n]).abs()
        per_row = d.reshape(got.shape[0], rows, -1).amax(dim=(0, 2))
        top = torch.topk(per_row, min(4, rows))
        out[lvl] = {"max": float(d.max()),
                    "scale": float(want[:, start:start + n].abs().max()),
                    "rows": rows, "worst_rows": top.indices.tolist(),
                    "worst": [float(v) for v in top.values]}
        start += n
    return out


def main(preset: str, dtype: str) -> None:
    import detjax_torch
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.parallel import make_mesh
    from detjax_torch.parallel.mesh import RowRunner, replicate
    from detjax_torch.serve import DetectionServer

    cs.print_card()
    cfg = cs.space_serve_config(preset, **{"model.dtype": dtype})
    model = detjax_torch.build_model(cfg, seed=0)
    canvases = cs.seeded_canvases(15, 8, cfg.model.image_size)
    cs.desaturate_(model, canvases[:4], cfg)
    mesh = make_mesh(["cuda:0", "cuda:0"], spatial=2)
    dev = next(model.parameters()).device
    flags = []

    def forward(m, block):
        flags.append((torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.benchmark,
                      torch.backends.cudnn.deterministic))
        x = normalize_u8(torch.as_tensor(block).to(dev), cfg.data.mean,
                         cfg.data.std, m.compute_dtype)
        return Heads(*m(x.permute(0, 3, 1, 2)))

    res = {}
    with cs.tf32_off(), torch.inference_mode():
        x = cs.normalized_nchw(model, canvases, cfg)
        want, again = model(x), model(x)
        runner = RowRunner(dev, mesh, forward, replicate(model, mesh))
        try:
            got, got2 = runner(canvases), runner(canvases)
        finally:
            runner.close()
        res["unsplit_repeat_equal"] = [torch.equal(a, b)
                                       for a, b in zip(want, again)]
        res["split_repeat_equal"] = [torch.equal(a, b)
                                     for a, b in zip(got, got2)]
        res["flags_in_shards"] = flags[:2]
        res["cls"] = level_gaps(got.cls, want[0], cfg)
        res["box"] = level_gaps(got.box, want[1], cfg)
    print(json.dumps({"probe": "heads", **res}))

    with cs.tf32_off():
        kw = dict(batch_size=8, score_threshold=0.0)
        plain = DetectionServer(model, cfg, **kw)
        split = DetectionServer(model, cfg, mesh=mesh, **kw)
        try:
            w_slots, g_slots = plain._runs[0](canvases), split._runs[0](
                canvases)
            w2, g2 = plain._runs[0](canvases), split._runs[0](canvases)
        finally:
            plain.shutdown()
            split.shutdown()
    print(json.dumps({"probe": "repeat",
                      "plain_bit_equal": cs.slots_bit_equal(w_slots, w2),
                      "split_bit_equal": cs.slots_bit_equal(g_slots, g2)}))
    for i, ((gb, gs, gl, _), (wb, ws, wl, wn)) in enumerate(
            zip(g_slots, w_slots)):
        bad = np.nonzero(np.abs(gb[:wn] - wb[:wn]).max(1) > 5e-3)[0]
        rows = [{"pos": int(p),
                 "got": [float(gs[p]), int(gl[p]), gb[p].tolist()],
                 "want": [float(ws[p]), int(wl[p]), wb[p].tolist()],
                 "got_box_in_want_at": np.nonzero(
                     np.abs(wb[:wn] - gb[p]).max(1) < 5e-3)[0].tolist(),
                 "want_neighbour_scores": ws[max(p - 2, 0):p + 3].tolist()}
                for p in bad[:6]]
        print(json.dumps({"slot": i, "n": int(wn), "bad": len(bad),
                          "max_score_gap": float(np.abs(gs[:wn]
                                                        - ws[:wn]).max()),
                          "rows": rows}))


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args else "retinanet_r50_1024",
         args[1] if len(args) > 1 else "float32")

"""Cells cut to sizes a CPU test run holds: the same code paths as on the
card (the trainer takes the tiled blend on the CPU), smaller images, maps
and streams."""
from __future__ import annotations

import copy

from portbench import harness


def small_cell(name: str, scale: float):
    """``name``'s cell with its image scaled by ``scale`` and its traffic
    cut to a few keyframes or queries."""
    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cal = cfg["Dataset"]["Calibration"]
    W, H = int(640 * scale), int(480 * scale)
    cal.update(width=W, height=H, fx=cal["fx"] * scale,
               fy=cal["fy"] * scale, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    cfg["tpu"]["capacity"] = 16384
    cell.config = cfg
    tr = dict(cell.traffic)
    if tr["generator"] == "mapping":
        tr.update(keyframes=6, landmarks=40, warmup_iters=4, chunk_iters=2)
    else:
        tr.update(gaussians=12000, key_gaussians=5000, landmarks=800,
                  database_views=12, queries=12, keypoints=1024,
                  warmup_queries=1, sample=3,
                  traced_queries=1)
    cell.traffic = tr
    return cell

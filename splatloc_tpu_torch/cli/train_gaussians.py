"""Scene mapping entry point (reference train_gaussians.py).

Port of ``splatloc_tpu.cli.train_gaussians``: the same arguments, log
lines, ``metrics.jsonl`` records and output path
(``<save_dir>/point_cloud/final/point_cloud.ply``). The trainer runs on
``device`` (CUDA unless the caller asks for the CPU) and picks the raster
path by it: the pair kernels on the card, the tiled blend on the CPU.

Usage: python -m splatloc_tpu_torch.cli.train_gaussians --config <yaml>
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import yaml

from splatloc_tpu_torch.cli.config import load_config, save_dir_for
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer


def run(config: dict, save_dir: str | None = None,
        capacity: int = 2 ** 19, max_frames: int | None = None,
        refinement_iters: int = 26000, log_every: int = 20,
        trace_dir: str | None = None, trace_kf: int = 0,
        device="cuda") -> str:
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.dist import multihost
    from splatloc_tpu_torch.utils.profiling import MetricsLogger, trace

    multihost.initialize()   # no-op unless the SPLATLOC_* env contract set
    dataset = load_dataset(config, train=True)
    mcfg = MappingConfig.from_config(config)
    n_frames = len(dataset) if max_frames is None else min(len(dataset),
                                                           max_frames)
    trainer = MappingTrainer(mcfg, capacity=capacity,
                             frame_capacity=n_frames + 1, device=device)
    # structured jsonl metrics stream next to the map; host-side artifacts
    # are process-0-only under multi-process runs
    mlog = (MetricsLogger(os.path.join(save_dir, "metrics.jsonl"))
            if save_dir and multihost.is_primary() else None)

    kf_interval = config["Training"]["kf_interval"]
    iters_per_kf = config["Training"]["mapping_itr_num"]
    t0 = time.time()
    for idx in range(0, n_frames, kf_interval):
        frame = dataset.get_frame(idx)
        if not frame["valid"]:
            continue
        score = frame.get("sp_kp_score",
                          np.zeros((dataset.height, dataset.width),
                                   np.float32))
        trainer.add_keyframe(frame["rgb"], frame["depth"],
                             np.asarray(score, np.float32), frame["w2c"])
        t_kf = time.time()
        if trace_dir is not None and idx == trace_kf:
            # opt-in device-trace window around one keyframe's map() block
            with trace(trace_dir, device):
                loss = trainer.map(iters=iters_per_kf)
        else:
            loss = trainer.map(iters=iters_per_kf)
        if mlog is not None:
            dt = max(time.time() - t_kf, 1e-9)
            mlog.log(trainer.iteration, kf=idx, loss=loss,
                     it_per_s=round(iters_per_kf / dt, 3),
                     n_alive=int(trainer.scene.num_alive),
                     n_dropped_total=trainer.n_dropped_total,
                     capacity=trainer.scene.capacity)
        if log_every and (idx // kf_interval) % log_every == 0:
            print(f"kf {idx}: loss {loss:.4f} "
                  f"alive {int(trainer.scene.num_alive)} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    trainer.color_refinement(refinement_iters,
                             log_every=max(refinement_iters // 10, 1))
    if mlog is not None:
        mlog.log(trainer.iteration, phase="refined",
                 n_alive=int(trainer.scene.num_alive),
                 n_dropped_total=trainer.n_dropped_total,
                 wall_s=round(time.time() - t0, 1))

    if save_dir and multihost.is_primary():
        out = os.path.join(save_dir, "point_cloud", "final",
                           "point_cloud.ply")
        ply.save_scene(trainer.scene, out)
        print("saved", out)
        return out
    return ""


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--capacity", type=int, default=2 ** 19)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--refinement_iters", type=int, default=26000)
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="opt-in: capture a Perfetto device trace of "
                             "one keyframe's mapping block into this dir")
    parser.add_argument("--trace_kf", type=int, default=0,
                        help="keyframe index to trace (with --trace_dir)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "tiled blend)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    save_dir = None
    if config["Results"]["save_results"]:
        save_dir = save_dir_for(config)
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.yml"), "w") as f:
            yaml.dump(config, f)
        print("saving results in", save_dir)
    return run(config, save_dir, capacity=args.capacity,
               max_frames=args.max_frames,
               refinement_iters=args.refinement_iters,
               trace_dir=args.trace_dir, trace_kf=args.trace_kf,
               device=args.device)


if __name__ == "__main__":
    main()

"""The readings each limit of ``limits/<cell>.json`` is set from.

    python3 -m portbench.calibrate --workload <name> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, the program's compared
numbers (no timed window: the mapping cell's first steps, or the sampled
queries of one cycle of the stream run once each), the control's (the
plain reference one precision step below the configuration's, put in the
program's place) and a planted fault: for a mapping cell, half of each
window left out (its sum scaled to the whole window); for a localize
cell, the program's matches altered (``altered``). A state left unchanged
reads 1 on ``change_gap`` by construction and needs no run.
``--insert-only`` reads a mapping cell's insertion numbers alone. Prints
one JSON line per seed. Not part of a benchmark run; needs a card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

harness.set_process_env()


def readings(cell, seed: int, dev, insert_only: bool = False) -> dict:
    import torch
    drv = harness.generator(cell)
    if cell.traffic["generator"] == "mapping":
        pre = drv.prepare(cell, seed, dev)
        pre.pop("trainer")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if insert_only:
            return {"program": drv.insert_gaps(pre, dev),
                    "control": drv.insert_gaps(pre, dev, True)}
        prog = drv.compare(pre, dev)
        r = drv.reference_steps(pre, dev)
        rc = drv.reference_steps(pre, dev, dtype=torch.bfloat16)
        rh = drv.reference_steps(pre, dev, half_window=True)
        return {"program": prog,
                "control": {**drv.insert_gaps(pre, dev, True),
                            **drv.gaps(rc["loss"], rc["grad1"],
                                       rc["change"], r)},
                "fault_half_window": drv.gaps(rh["loss"], rh["grad1"],
                                              rh["change"], r)}
    pre = drv.prepare(cell, seed, dev)
    done = drv.sample_positions(pre, len(pre["order"]),
                                cell.traffic["sample"])
    poses = {p: drv.query(pre, p) for p in done}
    kept = drv.release(pre, dev)
    out = {"program": drv.compare(pre, kept, done, poses, dev),
           "control": drv.compare(pre, kept, done, poses, dev,
                                  control=True)}
    for rec in pre["rec"].values():
        rec["matches"] = altered(rec["matches"])
    fault = drv.compare(pre, kept, done, poses, dev)
    return {**out, "fault_matches": {"match_miss": fault["match_miss"]}}


def altered(matches):
    """A planted fault: every other match's query row moved to the next
    such match's."""
    import numpy as np
    m = np.array(matches)
    m[0, ::2] = np.roll(m[0, ::2], 1)
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--insert-only", action="store_true",
                    help="mapping cells: the insertion's numbers alone")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    import torch
    torch.set_num_threads(harness.CPU_THREADS)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    harness.bind_kernel_cache()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = {"workload": cell.name, "seed": seed,
               **readings(cell, seed, dev, args.insert_only),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

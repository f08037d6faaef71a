"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (inputs and weights from the seed, the cell's own shapes warmed),
then a window of ``--seconds``, then the plain reference's comparison. The
last line of standard output is the result; the compared numbers, each
beside its limit, are the last lines of standard error and the result's
last key. With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones. Needs the cards the cell asks for.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

harness.set_process_env()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)

    import torch
    torch.set_num_threads(harness.CPU_THREADS)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 2
    harness.bind_kernel_cache()
    out = harness.generator(cell).run(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0),
                                   T_START)
    return report(cell, out, bool(args.trace))


def report(cell, out: dict, trace: bool, stream=None) -> int:
    """Print the result line (and the checks on stderr); 0, or 3 where a
    forbidden module was loaded (no result is printed then)."""
    import torch
    stream = stream or sys.stdout
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: modules loaded that the port may not use: {bad}",
              file=sys.stderr)
        return 3
    correct, checks = harness.judge(out["values"], cell.limits)
    if trace:
        metrics = harness.per_layer_values(cell, out["ctx"])
    else:
        e2e = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = torch.device("cuda", 0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    tp = out["ctx"].get("trace")
    if trace and tp:
        device["busy_s"] = tp["busy_s"]
        device["window_s"] = tp["window_s"]
        line["breakdown"] = {"device_ops": tp["device_ops"],
                             "idle_gaps": tp["idle_gaps"]}
    for c in checks.values():
        # JSON has no infinity: a gap that is inf or nan is written as null
        if c["value"] is not None and not abs(c["value"]) < float("inf"):
            c["value"] = None
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=stream, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

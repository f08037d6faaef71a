"""The port's ``tools/bench_refine.py`` counterpart
(``splatloc_tpu_torch.tools.bench_refine``) against the JAX tool, which
takes its sizes and runs as it is, at a small size on the CPU: 20,000
Gaussians of ``quality_gate.make_gt_scene``'s room at 48x32, where both
packages' refinements converge (a sparser scene or a wider start leaves
them in different places, which says nothing about the port).
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import bench_refine as jbench_refine  # noqa: E402

from splatloc_tpu.core import transforms as jtransforms  # noqa: E402
from splatloc_tpu_torch.tools import bench_refine  # noqa: E402

torch.set_num_threads(1)

# eval_pose's limits on a pose: 2 mm, 0.1 deg
POSE_T_M, POSE_R_DEG = 2e-3, 0.1

REFINE_SIZE = dict(N=20_000, W=48, H=32)


def test_bench_refine_matches_jax_tool(capsys):
    """``bench_refine.main(n_seeds=1)`` small against
    ``tools/bench_refine.main`` at the same sizes: the same start twist
    and start pose, the start errors bit for bit, the final errors within
    eval_pose's 2 mm / 0.1 deg, and one JSON line with the JAX keys in
    their order."""
    want = jbench_refine.main(1, **REFINE_SIZE)
    capsys.readouterr()
    seeds = []
    got = bench_refine.main(1, device="cpu", **REFINE_SIZE,
                            on_seed=lambda s, rec: seeds.append(rec))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == got
    assert list(got) == list(want)

    xi = bench_refine.start_twist(0)
    srng = np.random.default_rng(100)
    axis = srng.normal(size=3)
    axis /= np.linalg.norm(axis)
    tdir = srng.normal(size=3)
    tdir /= np.linalg.norm(tdir)
    assert np.array_equal(xi, np.concatenate(
        [0.05 * tdir, np.radians(5.0) * axis]).astype(np.float32))
    jw2c0 = np.asarray(jtransforms.se3_exp(jnp.asarray(xi)) @ jnp.eye(4))
    rec = seeds[0]
    assert np.array_equal(rec["w2c0"], jw2c0)
    assert (rec["t0"], rec["r0"]) == jbench_refine._pose_err(
        rec["w2c0"], np.eye(4))
    assert bench_refine._pose_err(jw2c0, np.eye(4)) == \
        jbench_refine._pose_err(jw2c0, np.eye(4))
    for k in ("start_t_cm", "start_r_deg", "n_seeds"):
        assert got[k] == want[k], k
    assert abs(got["median_t_cm"] - want["median_t_cm"]) <= POSE_T_M * 100
    assert abs(got["median_r_deg"] - want["median_r_deg"]) <= POSE_R_DEG

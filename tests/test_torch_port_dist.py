"""Port parity for the multi-GPU layer (dist.multihost's mesh,
dist.sharded_raster, dist.shard): real processes joined by torch.distributed
over gloo on the CPU, spawned as tests/test_multihost.py spawns them, held
against the port's single-process paths and against the JAX package's
sharded functions on the conftest's virtual CPU mesh (its Pallas path in
interpret mode).

One spawn of 2 ranks and one of 4 serve every check: the ranks write their
results under tmp_path and the test process compares them."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.dist import make_mesh as jmake_mesh
from splatloc_tpu.dist import make_sharded_mapping_step as jsharded_step
from splatloc_tpu.dist import rasterize_sharded as jrasterize_sharded
from splatloc_tpu.dist import shard_scene as jshard_scene
from splatloc_tpu.scene import densify as jdensify
from splatloc_tpu.scene import optim as joptim
from splatloc_tpu.scene.gaussians import GaussianScene as JScene
from splatloc_tpu.train import mapping as jmapping
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.dist import multihost
from splatloc_tpu_torch.dist.sharded_raster import rasterize_sharded
from splatloc_tpu_torch.raster import rasterize
from splatloc_tpu_torch.raster.types import RasterConfig as TRasterConfig
from splatloc_tpu_torch.scene import densify as tdensify
from splatloc_tpu_torch.scene import optim as toptim
from splatloc_tpu_torch.scene.gaussians import GaussianScene as TScene
from splatloc_tpu_torch.train import mapping as tmapping

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIELDS = JScene.PARAM_FIELDS
N = 250                         # tests/test_dist.py's scene
CAM = dict(fx=50.0, fy=50.0, cx=32.0, cy=24.0, width=64, height=48)
RCFG = dict(tile_size=16, tile_chunk=4, use_pallas=True)
ROWS = 16                       # hopper_raster._rows_for(C=4)
# tests/test_dist.py::test_sharded_mapping_step_runs' configuration; "pair"
# takes the pair path (the kernels' plain versions) instead of the tiled
# blend the CPU picks by default
STEP_CFG = dict(width=32, height=32, fx=30.0, fy=30.0, cx=16.0, cy=16.0,
                window_size=2, tile_chunk=2, max_per_tile=128)
STEP_VARIANTS = {"blend": {}, "pair": {"use_pallas": True}}
STEP_CAP = 128

_CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.dist import multihost, shard
from splatloc_tpu_torch.dist.sharded_raster import rasterize_sharded
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene import densify, optim
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train import mapping
from splatloc_tpu_torch.utils.profiling import log_collectives

work = sys.argv[1]
spec = json.loads(sys.argv[2])
assert multihost.initialize(), "expected a multi-process group"
rank, world = dist.get_rank(), dist.get_world_size()
assert dist.get_backend() == "gloo"


def save(name, **arrays):
    np.savez(os.path.join(work, f"{name}_{rank}.npz"), **arrays)


if "mesh" in spec:
    mesh = multihost.global_mesh(data=world)
    y = mesh.all_reduce(torch.tensor([float(rank + 1)]), "data")

    @multihost.primary_only
    def write_report(path, value):
        with open(path, "w") as f:
            json.dump({"process": rank, "sum": value}, f)

    write_report(os.path.join(work, "report.json"), float(y[0]))
    save("mesh", index=mesh.index("data"), sum=y.numpy())

if "raster" in spec:
    inp = np.load(os.path.join(work, "raster_in.npz"))
    leaves = [torch.from_numpy(inp[k]).requires_grad_(True)
              for k in ("means", "scales", "quats", "opac", "colors")]
    cam = Camera.create(inp["w2c"], **spec["raster"]["cam"], device="cpu")
    cfg = RasterConfig(**spec["raster"]["cfg"])
    mesh = multihost.global_mesh(tile=world)
    with log_collectives() as fwd_log:
        out = rasterize_sharded(*leaves, cam, cfg, mesh)
    loss = torch.mean(out.image ** 2) + 0.1 * torch.mean(out.depth)
    with log_collectives() as bwd_log:
        grads = torch.autograd.grad(loss, leaves)
    save("raster", image=out.image.detach().numpy(),
         depth=out.depth.detach().numpy(), alpha=out.alpha.detach().numpy(),
         counters=np.array([int(out.n_dropped), int(out.n_trunc),
                            int(out.n_vis_dropped)]),
         **{f"g_{i}": g.numpy() for i, g in enumerate(grads)})
    with open(os.path.join(work, f"raster_log_{rank}.json"), "w") as f:
        json.dump({"forward": fwd_log, "backward": bwd_log}, f)

if "step" in spec:
    inp = np.load(os.path.join(work, "step_in.npz"))
    mesh = shard.make_mesh(**spec["step"]["mesh"])
    scene = GaussianScene(**{k: torch.from_numpy(inp["scene_" + k])
                             for k in shard.SCENE_FIELDS}, sh_degree=0)
    frames = {k: torch.from_numpy(inp["frames_" + k])
              for k in ("rgb", "depth_mm", "score", "w2c", "exposure")}
    opt = optim.init(scene.params())
    stats = densify.DensifyStats.zeros(scene.capacity, "cpu")
    for name, changes in spec["step"]["variants"].items():
        cfg = mapping.MappingConfig(**spec["step"]["cfg"], **changes)
        step = shard.make_sharded_mapping_step(cfg, mesh)
        res = {}
        for run in (0, 1):
            opt_sh, stats_sh = shard.shard_state(mesh, opt, stats)
            s, o, st, loss, vis, nd = step(shard.shard_scene(mesh, scene),
                                           opt_sh, stats_sh, frames, 1)
            full = shard.gather_scene(mesh, s)
            res.update({f"{run}_loss": loss.numpy(), f"{run}_nd": nd.numpy()})
            for k in shard.SCENE_FIELDS:
                res[f"{run}_scene_{k}"] = getattr(full, k).numpy()
            for k in scene.params():
                res[f"{run}_m_{k}"] = mesh.all_gather(o.m[k], "gauss").numpy()
            for k in shard.STATS_FIELDS:
                res[f"{run}_stats_{k}"] = mesh.all_gather(
                    getattr(st, k), "gauss").numpy()
            res[f"{run}_vis"] = mesh.all_gather(vis, "gauss").numpy()
        save("step_" + name, **res)
print("rank", rank, "ok", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(work: Path, world: int, spec: dict, timeout: float = 240.0):
    """Runs _CHILD in ``world`` processes joined through
    multihost.initialize's environment contract; fails the test if any
    rank fails or the group outlives ``timeout`` seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["SPLATLOC_COORDINATOR"] = f"localhost:{_free_port()}"
    env["SPLATLOC_NUM_PROCESSES"] = str(world)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(work), json.dumps(spec)],
        env=dict(env, SPLATLOC_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world}-rank group timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _scene_arrays(seed=0, n=N) -> dict:
    """tests/test_dist.py's _scene."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    return dict(means=means, scales=scales, quats=quats, opac=opac,
                colors=colors, w2c=np.eye(4, dtype=np.float32))


def _step_arrays(seed=0) -> dict:
    """tests/test_dist.py::test_sharded_mapping_step_runs' state, built on
    the JAX side (its FrameStore rounds the frames) and read out as numpy."""
    rng = np.random.default_rng(seed)
    cfg = jmapping.MappingConfig(**STEP_CFG)
    scene = JScene.empty(STEP_CAP)
    n = 64
    scene = scene.replace(
        xyz=scene.xyz.at[:n].set(jnp.asarray(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            + np.array([0, 0, 2.5], np.float32))),
        scaling=scene.scaling.at[:n].set(np.log(0.05)),
        opacity=scene.opacity.at[:n].set(0.5),
        alive=jnp.arange(STEP_CAP) < n)
    fs = jmapping.FrameStore(2, cfg.height, cfg.width)
    for i in range(2):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.02 * i
        fs.append(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                  np.full((32, 32), 2.5, np.float32),
                  np.zeros((32, 32), np.float32), w2c)
    frames = fs.gather(jnp.arange(2))
    out = {f"scene_{k}": np.asarray(getattr(scene, k))
           for k in FIELDS + ("alive",)}
    out.update({f"frames_{k}": np.asarray(v) for k, v in frames.items()})
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs, and the results of a 2-rank group (global mesh, tile
    render at D = 2) and a 4-rank group (tile render at D = 4 with its
    collectives logged, the mapping step on a (data=2, gauss=2) mesh)."""
    root = tmp_path_factory.mktemp("dist")
    raster_spec = {"cam": CAM, "cfg": RCFG}
    step_spec = {"mesh": {"data": 2, "gauss": 2}, "cfg": STEP_CFG,
                 "variants": STEP_VARIANTS}
    dirs = {}
    for world, spec in ((2, {"mesh": 1, "raster": raster_spec}),
                        (4, {"raster": raster_spec, "step": step_spec})):
        d = root / f"w{world}"
        d.mkdir()
        np.savez(d / "raster_in.npz", **_scene_arrays())
        np.savez(d / "step_in.npz", **_step_arrays())
        _spawn(d, world, spec)
        dirs[world] = d
    return dirs


def _leaves(arrays, grad=True):
    return [torch.from_numpy(arrays[k]).requires_grad_(grad)
            for k in ("means", "scales", "quats", "opac", "colors")]


def _tcam(arrays):
    return TCamera.create(arrays["w2c"], **CAM, device="cpu")


def _loss(out):
    return torch.mean(out.image ** 2) + 0.1 * torch.mean(out.depth)


@pytest.fixture(scope="module")
def single_process():
    """The port's single-process render of the scene and its grads."""
    arrays = _scene_arrays()
    leaves = _leaves(arrays)
    out = rasterize(*leaves, _tcam(arrays), TRasterConfig(**RCFG))
    grads = torch.autograd.grad(_loss(out), leaves)
    return out, [g.numpy() for g in grads]


def _sharded_results(work, D: int) -> list:
    if D == 1:
        arrays = _scene_arrays()
        leaves = _leaves(arrays)
        out = rasterize_sharded(*leaves, _tcam(arrays),
                                TRasterConfig(**RCFG),
                                multihost.global_mesh(tile=1))
        grads = torch.autograd.grad(_loss(out), leaves)
        return [dict(image=out.image.detach().numpy(),
                     depth=out.depth.detach().numpy(),
                     alpha=out.alpha.detach().numpy(),
                     counters=np.array([int(out.n_dropped),
                                        int(out.n_trunc),
                                        int(out.n_vis_dropped)]),
                     **{f"g_{i}": g.numpy() for i, g in enumerate(grads)})]
    return [dict(np.load(work[D] / f"raster_{r}.npz")) for r in range(D)]


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_render_matches_single_process(work, single_process, D):
    """Every rank's image, depth and alpha are the single-process render's
    bits (each tile walks the same pairs from the same global origin); the
    grads of all five inputs agree to 1e-6 (a Gaussian's per-tile sums are
    added across ranks in another order). Nothing is dropped; D = 4 puts
    the 3 tile rows of a 64x48 image on 4 ranks, the last one all phantom."""
    out, grads = single_process
    for res in _sharded_results(work, D):
        np.testing.assert_array_equal(res["image"], out.image.detach())
        np.testing.assert_array_equal(res["depth"], out.depth.detach())
        np.testing.assert_array_equal(res["alpha"], out.alpha.detach())
        np.testing.assert_array_equal(res["counters"], [0, 0, 0])
        for i, g in enumerate(grads):
            np.testing.assert_allclose(res[f"g_{i}"], g, rtol=0, atol=1e-6,
                                       err_msg=f"input {i}")
        assert np.abs(res["g_0"]).max() > 0


def test_sharded_render_matches_jax(work):
    """The port's 4-rank render against the JAX package's
    rasterize_sharded on 4 devices of the conftest's CPU mesh: the render
    limits of the single-device parity (image 5e-5, depth 2e-4) and the
    gradients of all five inputs within 1e-3 relative L2."""
    arrays = _scene_arrays()
    jleaves = [jnp.asarray(arrays[k])
               for k in ("means", "scales", "quats", "opac", "colors")]
    cam = JCamera.create(arrays["w2c"], CAM["fx"], CAM["fy"], CAM["cx"],
                         CAM["cy"], CAM["width"], CAM["height"])
    from splatloc_tpu.raster import RasterConfig as JRasterConfig
    cfg = JRasterConfig(**RCFG)
    mesh = Mesh(np.array(jax.devices()[:4]), ("tile",))

    def loss(*leaves):
        o = jrasterize_sharded(*leaves, cam, cfg, mesh)
        return jnp.mean(o.image ** 2) + 0.1 * jnp.mean(o.depth), o

    (_, jo), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jleaves)
    for res in _sharded_results(work, 4):
        np.testing.assert_allclose(res["image"], np.asarray(jo.image),
                                   atol=5e-5)
        np.testing.assert_allclose(res["depth"], np.asarray(jo.depth),
                                   atol=2e-4)
        np.testing.assert_array_equal(
            res["counters"], [int(jo.n_dropped), int(jo.n_trunc),
                              int(jo.n_vis_dropped)])
        for i, g in enumerate(jg):
            assert _rel_l2(res[f"g_{i}"], np.asarray(g)) <= 1e-3, i


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_collectives(work, D):
    """The counterpart of tests/test_dist.py::
    test_sharded_backward_comm_volume on the collectives the ranks called:
    the forward sums the two drop counters and gathers each rank's
    [Tl, C+4, P] accumulators (image-sized); the backward's one collective
    is the sum of the [n, rows] per-Gaussian grads, within 2 x n x rows x 4
    bytes. No collective carries pair-sized data."""
    T_rows = -(-CAM["height"] // RCFG["tile_size"])
    gx = -(-CAM["width"] // RCFG["tile_size"])
    Tl = -(-T_rows // D) * gx
    P = RCFG["tile_size"] ** 2
    for r in range(D):
        log = json.loads((work[D] / f"raster_log_{r}.json").read_text())
        assert [(c["op"], c["shape"], c["dtype"]) for c in log["forward"]] \
            == [("all_reduce", [2], "int32"),
                ("all_gather", [Tl, 8, P], "float32")]
        assert [(c["op"], c["shape"], c["dtype"]) for c in
                log["backward"]] == [("all_reduce", [N, ROWS], "float32")]
        assert max(c["bytes"] for c in log["backward"]) <= 2 * N * ROWS * 4


def _port_step_inputs(arrays):
    scene = TScene(**{k: torch.from_numpy(np.array(arrays["scene_" + k]))
                      for k in FIELDS + ("alive",)}, sh_degree=0)
    frames = {k: torch.from_numpy(np.array(arrays["frames_" + k]))
              for k in ("rgb", "depth_mm", "score", "w2c", "exposure")}
    return scene, frames


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_sharded_mapping_step_matches_unsharded(work, variant):
    """The (data=2, gauss=2) step against the port's unsharded step from
    the same state: loss rtol 1e-5, xyz atol 1e-5, the Adam moments (0.1 x
    the gradient) within 1e-5 relative L2, visibility, counters and visit
    counts equal; two sharded runs agree bit for bit."""
    res = dict(np.load(work[4] / f"step_{variant}_0.npz"))
    for k, v in res.items():
        if k.startswith("0_"):
            np.testing.assert_array_equal(res["1_" + k[2:]], v, err_msg=k)
    scene, frames = _port_step_inputs(_step_arrays())
    cfg = tmapping.MappingConfig(**STEP_CFG, **STEP_VARIANTS[variant])
    s, o, st, loss, vis, nd = tmapping.make_mapping_step(cfg)(
        scene, toptim.init(scene.params()),
        tdensify.DensifyStats.zeros(STEP_CAP, "cpu"), frames, 1)
    np.testing.assert_allclose(res["0_loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(res["0_scene_xyz"], s.xyz.numpy(), atol=1e-5)
    np.testing.assert_array_equal(res["0_scene_alive"], s.alive.numpy())
    for k in FIELDS:
        b = o.m[k].numpy()
        if b.size and np.abs(b).max() > 0:
            assert _rel_l2(res["0_m_" + k], b) <= 1e-5, k
        else:
            np.testing.assert_array_equal(res["0_m_" + k], b, err_msg=k)
    assert np.abs(res["0_m_xyz"]).max() > 0
    np.testing.assert_array_equal(res["0_vis"], vis.numpy())
    np.testing.assert_array_equal(res["0_nd"], nd.numpy())
    np.testing.assert_array_equal(res["0_stats_denom"], st.denom.numpy())
    np.testing.assert_array_equal(res["0_stats_max_radii2d"],
                                  st.max_radii2d.numpy())
    assert _rel_l2(res["0_stats_xyz_gradient_accum"],
                   st.xyz_gradient_accum.numpy()) <= 1e-5


def test_sharded_mapping_step_matches_jax(work):
    """The port's (data=2, gauss=2) step against the JAX package's
    make_sharded_mapping_step on a (2, 2) CPU mesh: the loss within rel
    1e-5 and the gradients (m = 0.1 g) within the port's step-parity limit
    of 1e-3 relative L2."""
    arrays = _step_arrays()
    jscene = JScene.empty(STEP_CAP).replace(
        **{k: jnp.asarray(arrays["scene_" + k]) for k in FIELDS + ("alive",)})
    frames = {k: jnp.asarray(arrays["frames_" + k])
              for k in ("rgb", "depth_mm", "score", "w2c", "exposure")}
    mesh = jmake_mesh(data=2, gauss=2)
    step = jsharded_step(jmapping.MappingConfig(**STEP_CFG), mesh)
    _, jopt, _, jloss, jvis, jnd = step(
        jshard_scene(mesh, jscene), joptim.init(jscene.params()),
        jdensify.DensifyStats.zeros(STEP_CAP), frames, jnp.asarray(1))
    res = dict(np.load(work[4] / "step_blend_0.npz"))
    np.testing.assert_allclose(res["0_loss"], float(jloss), rtol=1e-5)
    for k in FIELDS:
        b = np.asarray(jopt.m[k])
        if b.size and np.abs(b).max() > 0:
            assert _rel_l2(res["0_m_" + k], b) <= 1e-3, k
        else:
            np.testing.assert_array_equal(res["0_m_" + k], b, err_msg=k)
    np.testing.assert_array_equal(res["0_vis"], np.asarray(jvis))
    np.testing.assert_array_equal(res["0_nd"], np.asarray(jnd))


def test_global_mesh_two_processes(work):
    """The port's counterpart of tests/test_multihost.py: two processes
    joined by multihost.initialize, a global mesh over both, one all_reduce
    over it, and the report written by process 0 alone."""
    report = json.loads((work[2] / "report.json").read_text())
    assert report == {"process": 0, "sum": 3.0}
    for r in range(2):
        res = np.load(work[2] / f"mesh_{r}.npz")
        assert int(res["index"]) == r
        np.testing.assert_array_equal(res["sum"], [3.0])


def test_mesh_of_one_rank_needs_no_group():
    """Outside a process group a mesh of one rank works: index 0, and its
    collectives return their input."""
    mesh = multihost.global_mesh(data=1, gauss=1)
    assert mesh.shape == {"data": 1, "gauss": 1}
    assert mesh.index("data") == mesh.index("gauss") == 0
    x = torch.arange(3.0)
    assert mesh.all_reduce(x, "data") is x
    assert mesh.all_gather(x, "gauss") is x
    with pytest.raises(ValueError):
        multihost.global_mesh(data=2)

"""Port parity for the host modules of the mapping CLI: utils.profiling
(MetricsLogger, trace), utils.logging (Log),
dist.multihost.initialize (with a two-process gloo smoke mirroring
tests/test_multihost.py), the native PLY bindings against the Python
codec, the native frame prefetcher against the JAX package's, and
eval.visualize mirroring tests/test_visualize.py."""
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.data import native_io as jnative_io
from splatloc_tpu.eval import visualize as jvis
from splatloc_tpu.utils import logging as jlogging
from splatloc_tpu.utils import profiling as jprof
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.data import native_io
from splatloc_tpu_torch.dist import multihost
from splatloc_tpu_torch.eval import visualize as tvis
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.utils import logging as tlogging
from splatloc_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def test_metrics_logger_matches_jax(tmp_path):
    """The same jsonl records (the wall-time field aside) for the same
    calls, numpy and torch scalars as floats, read() back."""
    recs = {}
    for name, mod, scalar in (("jax", jprof, jnp.float32),
                              ("port", tprof, torch.tensor)):
        log = mod.MetricsLogger(str(tmp_path / name / "m.jsonl"))
        log.log(3, kf=0, loss=scalar(0.25), n_alive=17, tag="a")
        log.log(4, phase="refined", wall_s=1.5)
        recs[name] = log.read()
        with open(log.path) as f:
            assert [json.loads(x) for x in f] == recs[name]
    for a, b in zip(recs["port"], recs["jax"]):
        assert isinstance(a.pop("t"), float) and isinstance(b.pop("t"),
                                                           float)
        assert a == b
    assert recs["port"][0] == {"step": 3, "kf": 0.0, "loss": 0.25,
                               "n_alive": 17.0, "tag": "a"}


def test_log_matches_jax(capsys):
    for tag in ("SplatLoc-TPU", "Eval", "Warning", "other"):
        jlogging.Log("x", 1, tag=tag)
        j = capsys.readouterr().out
        tlogging.Log("x", 1, tag=tag)
        assert capsys.readouterr().out == j and "x 1" in j


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace on the CPU records the host's ops into one Chrome trace."""
    with tprof.trace(str(tmp_path), "cpu"):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_initialize_single_process(monkeypatch):
    """False without the contract and with one process; no group made."""
    for k in ("SPLATLOC_COORDINATOR", "SPLATLOC_NUM_PROCESSES",
              "SPLATLOC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("SPLATLOC_COORDINATOR", "localhost:1")
    monkeypatch.setenv("SPLATLOC_NUM_PROCESSES", "1")
    monkeypatch.setenv("SPLATLOC_PROCESS_ID", "0")
    assert multihost.initialize() is False
    assert multihost.initialize("localhost:1", 1, 0) is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()


_CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist

from splatloc_tpu_torch.dist import multihost

assert multihost.initialize(), "expected multi-process init"
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)

@multihost.primary_only
def write_report(path, value):
    with open(path, "w") as f:
        json.dump({"process": dist.get_rank(), "sum": value}, f)

write_report(os.path.join(sys.argv[1], "report.json"), float(x[0]))
dist.barrier()
dist.destroy_process_group()
print("child", os.environ["SPLATLOC_PROCESS_ID"], "ok", flush=True)
"""


def test_two_process_gloo_smoke(tmp_path):
    """Mirror of tests/test_multihost.py's smoke: two processes join under
    the SPLATLOC_* contract (gloo on the CPU), one all-reduce, and only
    rank 0 writes the report."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SPLATLOC_COORDINATOR=f"localhost:{port}",
               SPLATLOC_NUM_PROCESSES="2", CUDA_VISIBLE_DEVICES="")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path)],
        env=dict(env, SPLATLOC_PROCESS_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process smoke timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    assert report == {"process": 0, "sum": 3.0}


def _native_or_skip():
    if not native_io.available():
        pytest.skip("the native IO library does not build here")


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
def test_frame_prefetcher_matches_jax(tmp_path, rng, order):
    """Where the library loads: PNG frames read through the JAX package's
    FramePrefetcher and the port's give the same arrays, the written ones,
    with the frames asked for in order and out of it."""
    _native_or_skip()
    from PIL import Image
    n, w, h = 7, 24, 16
    paths, frames = ([], []), []
    for i in range(n):
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        dep = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        for k, img in enumerate((rgb, dep)):
            paths[k].append(str(tmp_path / f"{'rd'[k]}{i}.png"))
            Image.fromarray(img).save(paths[k][-1])
        frames.append((rgb, dep))
    idx = (list(range(n)) if order == "in_order"
           else [int(i) for i in rng.permutation(n)])
    got = {}
    for name, mod in (("jax", jnative_io), ("port", native_io)):
        pf = mod.FramePrefetcher(*paths, w, h, n_threads=2, read_ahead=3)
        try:
            got[name] = [pf.get(i) for i in idx]
        finally:
            pf.close()
    for i, (a, b) in zip(idx, zip(got["port"], got["jax"])):
        for x, y, want in zip(a, b, frames[i]):
            assert x.dtype == y.dtype == want.dtype
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, want)


def test_native_ply_writer_matches_python_codec(tmp_path, monkeypatch, rng):
    """Where the library loads: the native writer's file is byte for byte
    the Python codec's, and both readers give the same columns."""
    _native_or_skip()
    names = ["x", "y", "z", "opacity", "kp_score"]
    data = rng.normal(size=(77, 5)).astype(np.float32)
    fast = str(tmp_path / "native.ply")
    ply.write_ply(fast, names, data)
    assert native_io.ply_read_f32(fast) is not None
    got_fast = ply.read_ply_vertices(fast)
    monkeypatch.setattr(native_io, "available", lambda: False)
    slow = str(tmp_path / "python.ply")
    ply.write_ply(slow, names, data)
    with open(fast, "rb") as a, open(slow, "rb") as b:
        assert a.read() == b.read()
    got_slow = ply.read_ply_vertices(slow)
    assert list(got_fast) == list(got_slow) == names
    for k in names:
        np.testing.assert_array_equal(got_fast[k], got_slow[k])
        np.testing.assert_array_equal(got_fast[k], data[:, names.index(k)])


def test_visualize_arrays_match_jax(rng):
    """colormap_jet, draw_matches, feature_pca_rgb and replay_frame give the
    JAX package's arrays (tests/test_visualize.py's inputs)."""
    x = np.linspace(0, 1, 64).reshape(8, 8)
    np.testing.assert_array_equal(tvis.colormap_jet(x), jvis.colormap_jet(x))
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    kpa = rng.uniform(0, 39, (10, 2)).astype(np.float32)
    kpb = rng.uniform(0, 39, (10, 2)).astype(np.float32)
    inl = np.arange(10) % 2 == 0
    img = tvis.draw_matches(a, b, kpa, kpb, inliers=inl)
    assert img.shape == (32, 80, 3)
    np.testing.assert_array_equal(img, jvis.draw_matches(a, b, kpa, kpb,
                                                         inliers=inl))
    feat = rng.normal(size=(16, 16, 32)).astype(np.float32)
    np.testing.assert_array_equal(tvis.feature_pca_rgb(feat),
                                  jvis.feature_pca_rgb(feat))
    render = rng.uniform(0, 1, (24, 32, 3))
    query = rng.uniform(0, 1, (24, 32, 3))
    gt = rng.normal(size=(5, 3)).astype(np.float32)
    frame = tvis.replay_frame(render, query, gt, gt + 0.05, 2)
    assert frame.shape == (24, 96, 3)
    np.testing.assert_array_equal(
        frame, jvis.replay_frame(render, query, gt, gt + 0.05, 2))


def test_debug_renders(tmp_path, rng):
    """Mirror of test_debug_renders: the default configuration (the tiled
    blend) renders the three dumps; the RGB dump matches the JAX package's
    within one level."""
    from PIL import Image
    from splatloc_tpu.core.camera import Camera as JCamera
    from splatloc_tpu.raster.types import RasterConfig as JRasterConfig
    from splatloc_tpu.scene import GaussianScene as JScene
    xyz = (rng.uniform(-0.3, 0.3, (10, 3)).astype(np.float32)
           + np.array([0, 0, 2], np.float32))
    js = JScene.empty(64)
    js = js.replace(xyz=js.xyz.at[:10].set(jnp.asarray(xyz)),
                    scaling=js.scaling.at[:10].set(np.log(0.05)),
                    opacity=js.opacity.at[:10].set(1.0),
                    alive=jnp.arange(64) < 10)
    ts = GaussianScene(**{k: torch.from_numpy(np.array(getattr(js, k)))
                          for k in GaussianScene.PARAM_FIELDS + ("alive",)},
                       sh_degree=0)
    args = (np.eye(4, dtype=np.float32), 20.0, 20.0, 16.0, 12.0, 32, 24)
    jvis.save_debug_renders(js, JCamera.create(*args), str(tmp_path / "j"),
                            0, JRasterConfig(tile_chunk=2))
    tvis.save_debug_renders(ts, Camera.create(*args, device="cpu"),
                            str(tmp_path / "t"), 0, RasterConfig(tile_chunk=2))
    tvis.save_debug_renders(ts, Camera.create(*args, device="cpu"),
                            str(tmp_path / "d"), 1)
    for sub, name in (("rgb", "rgb_0"), ("depth", "depth_0"),
                      ("opacity", "opacity_0")):
        a = np.asarray(Image.open(tmp_path / "t" / "rendering" / sub
                                  / f"{name}.png")).astype(int)
        b = np.asarray(Image.open(tmp_path / "j" / "rendering" / sub
                                  / f"{name}.png")).astype(int)
        assert np.abs(a - b).max() <= 1, sub
    assert os.path.exists(tmp_path / "d" / "rendering" / "depth"
                          / "depth_1.png")


def test_write_replay(tmp_path, rng):
    frames = [rng.integers(0, 255, (8, 12, 3)).astype(np.uint8)
              for _ in range(3)]
    tvis.write_replay(frames, str(tmp_path))
    assert sorted(p.name for p in tmp_path.glob("frame_*.png")) == [
        "frame_00000.png", "frame_00001.png", "frame_00002.png"]

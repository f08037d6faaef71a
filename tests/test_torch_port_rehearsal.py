"""The port's eval rehearsal (``splatloc_tpu_torch.tools.eval_rehearsal``)
against the JAX tool (``tools/eval_rehearsal.py``) and the JAX package, at
a small size on the CPU.

The JAX tool's sizes are literals inside its ``main``, so the reference
side here is a mirror of its steps (``tools/eval_rehearsal.py:78-252``)
built from the JAX package's functions at the port run's sizes. Each stage
of the mirror takes the port's inputs to that stage (its renders' depths
and grays, its query features, its decoded points, its kept matches), so a
stage is held on its own. The weights are the JAX package's, carried
across with ``convert``; PnP's RANSAC draws are JAX's own, injected into
the port.
"""
import ast
import inspect
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import eval_rehearsal as jtool  # noqa: E402

from splatloc_tpu.core import transforms as jt  # noqa: E402
from splatloc_tpu.core.camera import Camera as JCamera  # noqa: E402
from splatloc_tpu.eval import selection as jselection  # noqa: E402
from splatloc_tpu.fields import decoder as jdecoder  # noqa: E402
from splatloc_tpu.match import frustum as jfrustum  # noqa: E402
from splatloc_tpu.match import hungarian as jhung  # noqa: E402
from splatloc_tpu.match import localize as jloc  # noqa: E402
from splatloc_tpu.match import pnp as jpnp  # noqa: E402
from splatloc_tpu.match import superpoint as jsp  # noqa: E402
from splatloc_tpu.raster import render as jrender  # noqa: E402
from splatloc_tpu.raster import RasterConfig as JRasterConfig  # noqa: E402
from splatloc_tpu.scene.gaussians import GaussianScene as JScene  # noqa: E402
from splatloc_tpu_torch import convert  # noqa: E402
from splatloc_tpu_torch.core import transforms as tt  # noqa: E402
from splatloc_tpu_torch.match import pnp as tpnp  # noqa: E402
from splatloc_tpu_torch.tools import eval_rehearsal as ttool  # noqa: E402

torch.set_num_threads(1)

# the rehearsal at 64x48 (fx = W / 2, as the tool's 320 at 640): 2,000
# Gaussians, 8 database views, 1,500 key Gaussians and 1,500 mask pixels a
# frame (57-82 frustum points a query), 50 landmarks, database points
# padded to 256, 32 query key points (all valid), 4 queries, one
# refinement of 8 iterations a level. With fewer query key points than
# frustum points, every kept match is a real database point (none a pad
# row at the origin), so each query's PnP is well posed.
SMALL = dict(W=64, H=48, fx=32.0, n_gauss=2000, capacity=2048, n_train=8,
             n_key=1500, n_landmarks=50, mask_px=1500, max_points=256,
             max_keypoints=32, n_refine=1, refine_iters=8)
N_QUERIES = 4
# the limits of the port tests that hold each stage's function: renders
# (test_torch_port_raster), SuperPoint (test_torch_port_match), decode
# (test_torch_port_fields), the similarity (a 256-term float32 dot
# product), PnP (test_torch_port_match), refinement (test_torch_port_
# localize: 1 mm and 0.05 deg)
RENDER_TOL, DEPTH_TOL = 5e-5, 2e-4
SP_TOL = 1e-4
DECODE_TOL = 1e-5
SIM_TOL = 1e-6
PNP_TOL = 1e-4
REFINE_T_M, REFINE_R_DEG = 1e-3, 0.05


def _jax_priorities(seed: int, n_hypotheses: int, M: int) -> np.ndarray:
    """JAX's own RANSAC draws (pnp._solve_core): one uniform per point per
    hypothesis key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hypotheses)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (M,)))(keys))


def _small_K():
    W, H, fx = SMALL["W"], SMALL["H"], SMALL["fx"]
    return np.array([[fx, 0, (W - 1) / 2], [0, fx, (H - 1) / 2], [0, 0, 1]])


def _field_cfg():
    """The JAX tool's feature field (tools/eval_rehearsal.py:147-148)."""
    return jdecoder.FeatureFieldConfig(
        bound=((-2.5, 2.5), (-1.8, 1.8), (1.5, 6.0)), voxel_sdf=0.06)


def _replay_draws():
    """tools/eval_rehearsal.py:78-132's draws from default_rng(0) at the
    small size, in its order (the masks inside the render loop), and the
    JAX scene it builds from them."""
    N, CAP, n_key = SMALL["n_gauss"], SMALL["capacity"], SMALL["n_key"]
    W, H, mask_px = SMALL["W"], SMALL["H"], SMALL["mask_px"]
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-1.8, 1.8, N),
                    rng.uniform(1.5, 6.0, N)], -1).astype(np.float32)
    colors = rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    marker = np.zeros((CAP, 1), np.float32)
    key_idx = rng.choice(N, n_key, replace=False)
    marker[key_idx] = rng.uniform(0.01, 1.0, (n_key, 1))
    scene = JScene.empty(CAP)
    scene = scene.replace(
        xyz=scene.xyz.at[:N].set(xyz),
        scaling=scene.scaling.at[:N].set(
            rng.uniform(-4.6, -3.2, (N, 3)).astype(np.float32)),
        rotation=scene.rotation.at[:N].set(quats),
        opacity=scene.opacity.at[:N].set(1.5),
        f_dc=scene.f_dc.at[:N].set(
            ((colors - 0.5) / 0.28209479177387814)[:, None, :]),
        marker=jnp.asarray(marker),
        alive=scene.alive.at[:N].set(True))
    masks = []
    for _ in range(SMALL["n_train"]):
        mask = np.zeros((H, W), np.uint8)
        ys = rng.integers(0, H, mask_px)
        xs = rng.integers(0, W, mask_px)
        mask[ys, xs] = 1
        masks.append(mask)
    return scene, key_idx, masks


@pytest.fixture(scope="module")
def rehearsal():
    """The port's run at the small size on the CPU, with the JAX
    package's weights and RANSAC draws, and every query's record; beside
    it the JAX scene and weights."""
    fcfg = _field_cfg()
    jdec = jdecoder.init_decoder(fcfg, jax.random.key(0))
    jspp = jsp.init_params(jax.random.key(1))
    dec = convert.decoder_from_numpy(jax.tree.map(np.asarray, jdec),
                                     device="cpu")
    spp = convert.superpoint_from_numpy(
        {k: np.asarray(v) for k, v in jspp.items()}, device="cpu")
    solve = tpnp.solve_pnp_ransac

    def injected(pts2d, pts3d, K, n_hypotheses, device):
        return solve(pts2d, pts3d, K, n_hypotheses=n_hypotheses,
                     priorities=_jax_priorities(0, n_hypotheses,
                                                len(pts2d)),
                     device=device)
    recs = []
    with mock.patch.object(tpnp, "solve_pnp_ransac", injected):
        run = ttool.run(n_queries=N_QUERIES, device="cpu",
                        decoder_params=dec, sp_params=spp,
                        on_query=lambda qi, rec: recs.append(rec), **SMALL)
    jscene, key_idx, masks = _replay_draws()
    return {"run": run, "recs": recs, "jscene": jscene, "key_idx": key_idx,
            "masks": masks, "jdec": jdec, "jsp": jspp, "fcfg": fcfg}


# --------------------------------------------------------------------------
# the tool's own pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 100])
def test_orbit_pose_is_bit_identical(n):
    for i in range(n):
        a, b = jtool._orbit_pose(i, n), ttool._orbit_pose(i, n)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_fake_dataset_matches_the_jax_tool():
    K = _small_K()
    names = ["frame000000", "frame000001"]
    frames = {0: {"w2c": np.eye(4)}, 1: {"w2c": 2 * np.eye(4)}}
    a = jtool._FakeDataset(K, 64, 48, names, frames)
    b = ttool._FakeDataset(K, 64, 48, names, frames)
    for k in ("K", "width", "height", "fx", "fy", "cx", "cy"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for name in names:
        i = a.name_to_index(name)
        assert i == b.name_to_index(name)
        assert a.get_frame(i) is b.get_frame(i)


def test_result_keys_are_the_jax_tools(rehearsal):
    """The port's result line has the keys of the JAX tool's ``result``
    dict (read from its source), in its order."""
    tree = ast.parse((ROOT / "tools" / "eval_rehearsal.py").read_text())
    keys = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "result"):
            keys = [k.value for k in node.value.keys]
    assert keys and "ms_hungarian" in keys
    res = rehearsal["run"].result
    assert list(res) == keys
    # phase 17 of chip_smoke.py holds the card's run to the same keys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert list(chip_smoke.REHEARSAL_KEYS) == keys
    assert res["n_queries"] == N_QUERIES and res["finite"] is True
    assert res["image"] == "64x48" and res["n_gaussians"] == 2000
    # every query reached PnP, and every stage has its median
    assert all(r["n_real"] >= 5 for r in rehearsal["recs"])
    assert rehearsal["run"].pnp_errors == []
    assert all(res[k] is not None for k in keys if k.startswith("ms_"))


def test_run_defaults_to_the_card():
    for fn in (ttool.run, ttool.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    sig = inspect.signature(ttool.run).parameters
    # the JAX tool's constants (tools/eval_rehearsal.py:74-252)
    want = dict(n_queries=100, W=640, H=480, fx=320.0, n_gauss=110_000,
                capacity=111_232, n_train=100, n_key=30_000,
                n_landmarks=5000, mask_px=1500, max_points=4096,
                max_keypoints=4096, n_refine=3, refine_iters=64)
    assert {k: sig[k].default for k in want} == want
    assert (ttool.N_KEEP, ttool.N_HYPOTHESES) == (512, 256)


# --------------------------------------------------------------------------
# stage by stage against the JAX package
# --------------------------------------------------------------------------

def test_scene_and_mask_draws_are_bit_identical(rehearsal):
    """The scene (every field at full capacity) and each frame's key-point
    mask are the JAX tool's draws bit for bit."""
    run, js = rehearsal["run"], rehearsal["jscene"]
    for k in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
              "marker", "kp_score", "alive"):
        a, b = np.asarray(getattr(js, k)), getattr(run.scene, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for i, mask in enumerate(rehearsal["masks"]):
        f = run.frames[i]
        assert f["sp_kp_mask"].dtype == np.uint8
        assert np.array_equal(f["sp_kp_mask"], mask), i
        c2w = jtool._orbit_pose(i, SMALL["n_train"])
        assert np.array_equal(f["c2w"], c2w)
        assert np.array_equal(f["w2c"], np.linalg.inv(c2w).astype(np.float32))


def test_database_renders_match_jax(rehearsal):
    """Each database view's depth and gray against the JAX package's render
    on its CPU path (the tiled blend, as the tool's rcfg picks there)."""
    run, js = rehearsal["run"], rehearsal["jscene"]
    K, W, H = _small_K(), SMALL["W"], SMALL["H"]
    cam0 = JCamera.create(np.eye(4, dtype=np.float32), K[0, 0], K[1, 1],
                          K[0, 2], K[1, 2], W, H)
    render_j = jax.jit(lambda w2c: jrender(
        js, cam0.replace_pose(w2c), JRasterConfig(use_pallas=False)))
    for i in range(SMALL["n_train"]):
        out = render_j(jnp.asarray(run.frames[i]["w2c"]))
        rgb = np.asarray(out["render"])
        gray = np.clip(0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                       + 0.114 * rgb[..., 2], 0, 1)
        assert float(np.asarray(out["opacity"]).mean()) > 0.5
        np.testing.assert_allclose(run.frames[i]["depth"],
                                   np.asarray(out["depth"]), rtol=0,
                                   atol=DEPTH_TOL)
        np.testing.assert_allclose(run.grays[i], gray, rtol=0,
                                   atol=RENDER_TOL)


def test_selection_matches_jax(rehearsal):
    """select_landmarks on the port's depths: the same landmarks."""
    run = rehearsal["run"]
    xyz = np.asarray(rehearsal["jscene"].xyz)[:SMALL["n_gauss"]]
    n = SMALL["n_train"]
    sel = jselection.select_landmarks(
        xyz[rehearsal["key_idx"]], np.stack([run.frames[i]["w2c"]
                                             for i in range(n)]),
        _small_K(), np.stack([run.frames[i]["depth"] for i in range(n)]),
        SMALL["n_landmarks"])
    assert sel.shape == (SMALL["n_landmarks"], 3)
    np.testing.assert_array_equal(run.landmarks, sel)


def test_query_stages_match_jax(rehearsal):
    """Per query, each stage on the port's inputs to it: SuperPoint on the
    database gray (the same valid key points, descriptors to 1e-4), the
    frustum points (equal), the padded decode (1e-5 of the JAX package's
    eager decode, pad rows zero) and the assignment (the same matches,
    sims to 1e-6)."""
    run, js = rehearsal["run"], rehearsal["jscene"]
    K, W, H = _small_K(), SMALL["W"], SMALL["H"]
    alive = np.asarray(js.alive)
    xyz, marker = np.asarray(js.xyz)[alive], np.asarray(js.marker)[alive, 0]
    extract = jax.jit(lambda g: jsp.extract(
        rehearsal["jsp"], g, max_keypoints=SMALL["max_keypoints"]))
    assert len(rehearsal["recs"]) == N_QUERIES
    for qi, rec in enumerate(rehearsal["recs"]):
        i = qi % SMALL["n_train"]
        out = extract(jnp.asarray(run.grays[i], jnp.float32))
        valid = np.asarray(out["valid"])
        desc = np.array(out["descriptors"])
        desc[:, ~valid] = 0.0
        qf = rec["qf"]
        assert qf["n_valid"] == int(valid.sum()) > 5
        np.testing.assert_array_equal(qf["keypoints"],
                                      np.asarray(out["keypoints"]))
        np.testing.assert_allclose(qf["descriptors"], desc, rtol=0,
                                   atol=SP_TOL)

        f = run.frames[i]
        pts3d, _ = jfrustum.frustum_key_points(
            xyz, marker, f["w2c"], K, W, H, db_mask=f["sp_kp_mask"] == 1,
            db_depth=f["depth"], c2w=f["c2w"])
        n_real = min(len(pts3d), SMALL["max_points"])
        assert rec["n_real"] == n_real >= 5
        np.testing.assert_array_equal(rec["pts3d"][:n_real], pts3d[:n_real])
        assert not rec["pts3d"][n_real:].any()

        # the JAX tool calls decode_jit; on the CPU backend the jitted
        # form strays from its own semantics (bf16 operands, float32 sums)
        # by up to 1.1e-3 on a few of these points, where decode (eager)
        # and the port stay within 2.5e-7 of a float64 evaluation of them
        feats = jdecoder.decode(rehearsal["jdec"], jnp.asarray(rec["pts3d"]),
                                rehearsal["fcfg"])
        feats = np.asarray(feats.at[n_real:].set(0.0))
        np.testing.assert_allclose(rec["feats"].numpy(), feats, rtol=0,
                                   atol=DECODE_TOL)

        matches, sims = jhung.hungarian_solve(qf["descriptors"],
                                              rec["feats"].numpy().T,
                                              sim_thresh=0.4)
        np.testing.assert_array_equal(rec["matches"], np.asarray(matches))
        np.testing.assert_allclose(rec["sims"], np.asarray(sims), rtol=0,
                                   atol=SIM_TOL)



def test_pnp_stage_matches_jax(rehearsal):
    """The tool's PnP result on each query's kept matches (every one a
    real database point) against the JAX package's on the same matches,
    JAX's RANSAC draws injected: the same success and inliers, R and t to
    1e-4; the tool's solved count is the JAX package's."""
    run, K = rehearsal["run"], _small_K()
    solved = 0
    for rec in rehearsal["recs"]:
        keep, (rows, cols) = rec["keep"], rec["matches"]
        np.testing.assert_array_equal(
            keep, np.argsort(-rec["sims"])[:ttool.N_KEEP])
        assert len(keep) == SMALL["max_keypoints"]
        assert (cols[keep] < rec["n_real"]).all()
        q2d = rec["qf"]["keypoints"][rows[keep]].astype(np.float32)
        p3d = rec["pts3d"][cols[keep]].astype(np.float32)
        rj = jpnp.solve_pnp_ransac(q2d, p3d, K,
                                   n_hypotheses=ttool.N_HYPOTHESES)
        rt = rec["pnp"]
        assert rt["success"] == rj["success"]
        assert rt["num_inliers"] == rj["num_inliers"]
        np.testing.assert_array_equal(rt["inliers"], rj["inliers"])
        if rj["success"]:
            np.testing.assert_allclose(rt["r"], rj["r"], rtol=0, atol=PNP_TOL)
            np.testing.assert_allclose(rt["t"], rj["t"], rtol=0, atol=PNP_TOL)
        solved += bool(rj["success"])
    assert run.result["pnp_solved"] == solved


def _pose_err(A, B):
    d = A @ np.linalg.inv(B)
    c = np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(c)))


def test_refinement_matches_jax(rehearsal):
    """refine_pose from train view 0's true pose against its own render,
    on each package's CPU path (the tiled blend): the refined poses within
    1 mm and 0.05 deg of each other, the same seed count."""
    run, js = rehearsal["run"], rehearsal["jscene"]
    K, W, H = _small_K(), SMALL["W"], SMALL["H"]
    cam0 = JCamera.create(np.eye(4, dtype=np.float32), K[0, 0], K[1, 1],
                          K[0, 2], K[1, 2], W, H)
    (ref,) = run.refinements
    w2c0 = ref["w2c0"].numpy()
    assert np.array_equal(w2c0, run.frames[0]["w2c"])
    xj, ij = jloc.refine_pose(js, cam0, jnp.asarray(w2c0),
                              jnp.asarray(ref["gt"].numpy()),
                              iters=SMALL["refine_iters"])
    pj = np.asarray(jt.se3_exp(xj)) @ w2c0
    pt = tt.se3_exp(ref["xi"]).numpy() @ w2c0
    d, a = _pose_err(pt, pj)
    assert d < REFINE_T_M and a < REFINE_R_DEG, (d, a)
    assert ref["info"]["seed_evals"] == int(ij["seed_evals"]) == 17
    assert [lv["scale"] for lv in ref["info"]["levels"]] == [2, 1]
    assert all(lv["iters"] <= SMALL["refine_iters"]
               for lv in ref["info"]["levels"])

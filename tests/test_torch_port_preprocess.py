"""Port parity for the offline preprocessing: NetVLAD and retrieval
(``match.netvlad``), TSDF fusion and the fused feature cloud
(``fields.fusion``), the mesh (``fields.mesh``) and the three
``cli.preprocess`` commands, against the JAX package on the same numpy
inputs and the same dataset on disk."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from splatloc_tpu.cli import preprocess as jpre
from splatloc_tpu.data import synthetic as jsynth
from splatloc_tpu.fields import fusion as jfusion
from splatloc_tpu.fields import mesh as jmesh
from splatloc_tpu.match import netvlad as jnv
from splatloc_tpu.match import superpoint as jsp
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.cli import preprocess as tpre
from splatloc_tpu_torch.data import load_dataset
from splatloc_tpu_torch.fields import fusion as tfusion
from splatloc_tpu_torch.fields import mesh as tmesh
from splatloc_tpu_torch.match import netvlad as tnv
from splatloc_tpu_torch.scene.ply import read_ply_vertices

torch.set_num_threads(1)

W, H = 64, 48
GEN = dict(n_train=11, n_test=3, width=W, height=H, n_gauss=250,
           n_landmarks=30, desc_dim=256, seed=0)
VOXEL = 0.08
# tsdf: the JAX package's CPU build fuses the world-to-camera products and
# the running average into multiply-adds, so a voxel's value moves by a few
# float32 ulps (measured 4e-6); a voxel whose rounded pixel flips between
# the two builds differs in weight or colour, and at most this share of
# the voxels may flip, each within 1e-3 px of a pixel boundary in float64
TSDF_TOL = 1e-5
FLIP_SHARE = 1e-4
FLIP_PX = 1e-3
# NetVLAD: 13 float32 convolutions summed in another order (measured
# 2.4e-6 on unit descriptors)
NETVLAD_TOL = 1e-5


def _netvlad_npz(whiten_dim=32):
    """JAX NetVLAD init with unit-norm centers, as k-means centroids of
    L2-normalized descriptors are: at the init's N(0, 1) scale (norm ~23)
    the center term swamps the residuals and every image gets the same
    descriptor to 1e-6, so the ranking is a tie-break."""
    p = {k: np.asarray(v) for k, v in
         jnv.init_params(jax.random.PRNGKey(1), whiten_dim=whiten_dim).items()}
    c = p["vlad_centers"]
    p["vlad_centers"] = c / np.linalg.norm(c, axis=1, keepdims=True)
    return p


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pre"))
    config = jsynth.generate(os.path.join(root, "jax"), **GEN)
    shutil.copytree(os.path.join(root, "jax"), os.path.join(root, "port"))
    # the generated folder is what the commands write: start it empty
    for side in ("jax", "port"):
        shutil.rmtree(os.path.join(root, side, "generated"))
    sp = os.path.join(root, "superpoint.npz")
    nv = os.path.join(root, "netvlad.npz")
    np.savez(sp, **{k: np.asarray(v) for k, v in
                    jsp.init_params(jax.random.PRNGKey(0)).items()})
    np.savez(nv, **_netvlad_npz())
    configs = {}
    for side in ("jax", "port"):
        c = yaml.safe_load(yaml.safe_dump(config))
        c["Dataset"]["dataset_path"] = os.path.join(root, side, "scene")
        c["Dataset"]["generated_folder"] = os.path.join(root, side,
                                                        "generated")
        path = os.path.join(root, side, "config.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(c, f)
        configs[side] = (path, c)
    return configs, sp, nv


def test_netvlad_descriptor_matches_jax():
    p = _netvlad_npz()
    tp = convert.netvlad_from_numpy(p, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    for img in rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32):
        j = np.asarray(jnv.global_descriptor(jp, jnp.asarray(img)))
        t = tnv.global_descriptor(tp, torch.from_numpy(img)).numpy()
        assert t.shape == (32,)
        np.testing.assert_allclose(t, j, rtol=0, atol=NETVLAD_TOL)
    # without whitening: the flattened VLAD, cluster-major [K, 512]
    del p["whiten_w"], p["whiten_b"]
    j = np.asarray(jnv.global_descriptor({k: jnp.asarray(v) for k, v in
                                          p.items()}, jnp.asarray(img)))
    t = tnv.global_descriptor(convert.netvlad_from_numpy(p, device="cpu"),
                              torch.from_numpy(img)).numpy()
    assert t.shape == (64 * 512,)
    np.testing.assert_allclose(t, j, rtol=0, atol=NETVLAD_TOL)


def test_top_k_retrieval_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    db = rng.normal(size=(9, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    ji, jv = jnv.top_k_retrieval(jnp.asarray(q), jnp.asarray(db), k=4)
    ti, tv = tnv.top_k_retrieval(torch.from_numpy(q), torch.from_numpy(db),
                                 k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def _frames(config):
    ds = load_dataset(config, train=True)
    ds.load_score_flag = False
    return ds, [ds.get_frame(i) for i in range(len(ds))]


def _flipped_voxels_on_boundary(vol, frame, K, flipped):
    """Each flipped voxel projects, in float64, within FLIP_PX of a pixel
    boundary (x.5) in x or y: a float32 rounding can take either side."""
    X, Y, Z = vol.tsdf.shape
    idx = np.stack(np.unravel_index(np.nonzero(flipped.ravel())[0],
                                    (X, Y, Z)), -1).astype(np.float64)
    world = idx * vol.voxel_size + vol.origin.numpy().astype(np.float64)
    w2c = np.linalg.inv(frame["c2w"].astype(np.float64))
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    px = cam[:, 0] * K[0, 0] / cam[:, 2] + K[0, 2]
    py = cam[:, 1] * K[1, 1] / cam[:, 2] + K[1, 2]
    frac = np.minimum(np.abs(px - np.floor(px) - 0.5),
                      np.abs(py - np.floor(py) - 0.5))
    return bool((frac < FLIP_PX).all())


def _fused_pair(config):
    """Both packages' volumes after each frame of the dataset."""
    ds, frames = _frames(config)
    bound = np.asarray(config["scene"]["bound"], np.float32)
    jv = jfusion.TSDFVolume.create(bound, VOXEL)
    tv = tfusion.TSDFVolume.create(bound, VOXEL, device="cpu")
    steps = []
    for f in frames:
        jv = jfusion.integrate_frame(jv, f["depth"], f["rgb"], ds.K,
                                     f["c2w"])
        tv = tfusion.integrate_frame(tv, f["depth"], f["rgb"], ds.K,
                                     f["c2w"])
        steps.append((f, {k: (np.asarray(getattr(jv, k)),
                              getattr(tv, k).numpy())
                          for k in ("tsdf", "weight", "color")}))
    return ds, frames, jv, tv, steps


def test_integrate_frame_matches_jax(dataset):
    """Each frame's update: the voxels it observes on one side only (its
    weight step differs) lie on a pixel boundary; every flipped voxel so
    far stays within the budget; the rest of the tsdf within TSDF_TOL and
    the colours identical."""
    configs, _, _ = dataset
    ds, _, jv, tv, steps = _fused_pair(configs["port"][1])
    assert tv.tsdf.shape == jv.tsdf.shape
    prev = np.zeros(tv.tsdf.shape, np.float32)
    prev = (prev, prev)
    for f, grids in steps:
        wj, wt = grids["weight"]
        new = (wj - prev[0]) != (wt - prev[1])
        prev = (wj, wt)
        if new.any():
            assert _flipped_voxels_on_boundary(tv, f, ds.K, new)
        flipped = (wj != wt) | (grids["color"][0] != grids["color"][1]).any(
            -1)
        assert flipped.mean() <= FLIP_SHARE, flipped.sum()
        t_j, t_t = grids["tsdf"]
        np.testing.assert_allclose(t_t[~flipped], t_j[~flipped], rtol=0,
                                   atol=TSDF_TOL)
    assert (steps[-1][1]["weight"][1] > 0).mean() > 0.05


def _match(got, want, atol):
    """For each row of ``got`` the index of a row of ``want`` within
    ``atol`` (max norm), or -1."""
    d = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    j = d.argmin(1)
    return np.where(d[np.arange(len(got)), j] <= atol, j, -1)


def _unmatched_ok(m, n_want):
    """At most the flip budget's points unmatched on either side, and the
    matched ones in the same order."""
    hit = m[m >= 0]
    budget = max(2, int(FLIP_SHARE * 10 * n_want))
    return ((m < 0).sum() <= budget and n_want - len(hit) <= budget
            and bool((np.diff(hit) > 0).all()))


def test_surface_points_and_fused_features_match_jax(dataset):
    """extract_surface_points: the same points in the same (C) order, up
    to the crossings of a flipped voxel. Where a crossing runs from
    negative to positive tsdf the reference's fraction divides by
    max(t0 - t1, 1e-9) = 1e-9 and throws the point far outside the volume
    (both packages alike): no frame sees those, so fusion drops them.
    fuse_point_features on the same points: the same weights, features
    within 1e-5."""
    configs, _, _ = dataset
    ds, frames, jv, tv, _ = _fused_pair(configs["port"][1])
    jp, jc = jfusion.extract_surface_points(jv)
    tp, tc = tfusion.extract_surface_points(tv)
    lo = tv.origin.numpy() - VOXEL
    hi = lo + VOXEL * (np.asarray(tv.tsdf.shape) + 1)
    j_in = ((jp >= lo) & (jp <= hi)).all(1)
    t_in = ((tp >= lo) & (tp <= hi)).all(1)
    assert t_in.sum() > 100 and (~t_in).sum() > 0
    m = _match(tp[t_in], jp[j_in], 1e-5)
    assert _unmatched_ok(m, j_in.sum()), ((m < 0).sum(), j_in.sum())
    np.testing.assert_allclose(tc[t_in][m >= 0], jc[j_in][m[m >= 0]],
                               rtol=0, atol=1e-6)
    # a max_points cut draws from default_rng(0) over the whole list
    tsub, _ = tfusion.extract_surface_points(tv, max_points=50)
    assert tsub.shape == (50, 3)

    rng = np.random.default_rng(2)
    feat_maps = [rng.normal(size=(H, W, 16)).astype(np.float32)
                 for _ in frames]

    def stream():
        return ((m, f["depth"], f["c2w"]) for m, f in zip(feat_maps, frames))
    jf, jw = jfusion.fuse_point_features(jp[j_in], stream(), ds.K, 16)
    tf_, tw = tfusion.fuse_point_features(jp[j_in], stream(), ds.K, 16,
                                          device="cpu")
    np.testing.assert_array_equal(tw, jw)
    assert (tw > 0).mean() > 0.3
    np.testing.assert_allclose(tf_, jf, rtol=0, atol=1e-5)
    # the far points project outside every frame
    _, far_w = tfusion.fuse_point_features(tp[~t_in], stream(), ds.K, 16,
                                           device="cpu")
    assert not far_w.any()


def test_volume_save_load_round_trip(tmp_path, dataset):
    """The port's save_volume writes the JAX layout: each package loads the
    other's file bit for bit."""
    configs, _, _ = dataset
    _, _, jv, tv, _ = _fused_pair(configs["port"][1])
    p = str(tmp_path / "vol.npz")
    tfusion.save_volume(tv, p)
    back = jfusion.load_volume(p)
    np.testing.assert_array_equal(np.asarray(back.tsdf), tv.tsdf.numpy())
    np.testing.assert_array_equal(np.asarray(back.color), tv.color.numpy())
    assert back.voxel_size == tv.voxel_size
    assert back.sdf_trunc == tv.sdf_trunc
    q = str(tmp_path / "jvol.npz")
    jfusion.save_volume(jv, q)
    tb = tfusion.load_volume(q, device="cpu")
    np.testing.assert_array_equal(tb.weight.numpy(), np.asarray(jv.weight))
    np.testing.assert_array_equal(tb.origin.numpy(), np.asarray(jv.origin))


def test_get_mesh_matches_jax(tmp_path, dataset):
    """Marching tets on a fused volume: the same vertex and face counts,
    vertices within 1e-5, and the PLY round trip. Both read one volume
    (the port's, carried into a JAX TSDFVolume): marching tets is numpy on
    both sides."""
    configs, _, _ = dataset
    _, _, _, tv, _ = _fused_pair(configs["port"][1])
    jv = jfusion.TSDFVolume(origin=jnp.asarray(tv.origin.numpy()),
                            voxel_size=tv.voxel_size,
                            sdf_trunc=tv.sdf_trunc,
                            tsdf=jnp.asarray(tv.tsdf.numpy()),
                            weight=jnp.asarray(tv.weight.numpy()),
                            color=jnp.asarray(tv.color.numpy()))
    jverts, jfaces, jn, jc = jmesh.get_mesh(jv)
    verts, faces, normals, colors = tmesh.get_mesh(tv)
    assert verts.shape == jverts.shape and faces.shape == jfaces.shape
    assert faces.shape[0] > 100
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_array_equal(colors, jc)
    p = str(tmp_path / "mesh.ply")
    tmesh.save_mesh_ply(p, verts, faces, normals, colors)
    for got, want in zip(jmesh.load_mesh_ply(p), (verts, faces, normals,
                                                   colors)):
        np.testing.assert_array_equal(got, want)


def test_preprocess_commands_match_jax(dataset):
    """extract-features, gen-retrieval and gen-fusion of both packages on
    one dataset: identical retrieval tables, score maps within 1e-5, the
    query features' keypoints identical, the fused clouds' points within
    1e-4 m (up to a flipped voxel's) and their features within 1e-4, the
    meshes' counts within the flip budget."""
    configs, sp, nv = dataset
    for side, mod, extra in (("jax", jpre, []),
                             ("port", tpre, ["--device", "cpu"])):
        path = configs[side][0]
        mod.main(["extract-features", "--config", path, "--superpoint", sp]
                 + extra)
        mod.main(["gen-retrieval", "--config", path, "--netvlad", nv]
                 + extra)
        mod.main(["gen-fusion", "--config", path, "--superpoint", sp,
                  "--voxel_size", str(VOXEL)] + extra)
    gen = {s: os.path.join(configs[s][1]["Dataset"]["generated_folder"],
                           "scene") for s in configs}

    def read(side, *rel):
        return os.path.join(gen[side], *rel)

    with open(read("jax", "netvlad_retrieval.txt")) as f:
        jtab = f.read()
    with open(read("port", "netvlad_retrieval.txt")) as f:
        assert f.read() == jtab
    assert len(jtab.splitlines()) == GEN["n_test"]

    names = sorted(os.listdir(read("jax", "score_map")))
    assert names == sorted(os.listdir(read("port", "score_map")))
    assert len(names) == 3
    for n in names:
        np.testing.assert_allclose(np.load(read("port", "score_map", n)),
                                   np.load(read("jax", "score_map", n)),
                                   rtol=0, atol=1e-5)
    for n in sorted(os.listdir(read("jax", "query_features"))):
        j = np.load(read("jax", "query_features", n))
        t = np.load(read("port", "query_features", n))
        np.testing.assert_array_equal(t["keypoints"], j["keypoints"])
        np.testing.assert_allclose(t["descriptors"], j["descriptors"],
                                   rtol=0, atol=1e-5)

    jv = read_ply_vertices(read("jax", "sp_inloc_pc.ply"))
    tv = read_ply_vertices(read("port", "sp_inloc_pc.ply"))
    jxyz = np.stack([jv["x"], jv["y"], jv["z"]], -1)
    txyz = np.stack([tv["x"], tv["y"], tv["z"]], -1)
    assert txyz.shape[0] > 100
    m = _match(txyz, jxyz, 1e-4)
    assert _unmatched_ok(m, len(jxyz)), ((m < 0).sum(), len(jxyz))
    np.testing.assert_allclose(
        np.load(read("port", "sp_inloc_feat.npy"))[m >= 0],
        np.load(read("jax", "sp_inloc_feat.npy"))[m[m >= 0]],
        rtol=0, atol=1e-4)
    jm = jmesh.load_mesh_ply(read("jax", "mesh.ply"))
    tm = tmesh.load_mesh_ply(read("port", "mesh.ply"))
    for a, b in zip(tm, jm):
        assert abs(a.shape[0] - b.shape[0]) <= max(8, 1e-3 * b.shape[0])


def test_dense_descriptor_hooks_match_jax(tmp_path):
    """The dataset's dense-descriptor and fused-cloud hooks: sp_feature/
    {name}.pt read through load_sp_feat and get_frame's sp_feature branch
    (set_feature_flag), and gen-fusion without SuperPoint weights fusing
    those maps, as the JAX package does."""
    from splatloc_tpu.data import load_dataset as jload
    root = str(tmp_path)
    config = jsynth.generate(root, **{**GEN, "n_train": 6})
    shutil.rmtree(os.path.join(root, "generated"))
    tds = load_dataset(config, train=True)
    jds = jload(config, train=True)
    assert (tds.sp_feat_path, tds.sparse_ply, tds.sparse_feature) == (
        jds.sp_feat_path, jds.sparse_ply, jds.sparse_feature)
    os.makedirs(tds.sp_feat_path)
    rng = np.random.default_rng(4)
    for i in range(len(tds)):
        feat = torch.from_numpy(rng.normal(size=(1, 256, H, W)).astype(
            np.float32))
        torch.save(feat, os.path.join(tds.sp_feat_path,
                                      f"{tds.index_to_name(i)}.pt"))
    for ds in (tds, jds):
        ds.load_score_flag = False
        ds.set_feature_flag(True)
    tf, jf = tds.get_frame(1), jds.get_frame(1)
    assert tf["sp_feature"].shape == (H, W, 256)
    np.testing.assert_array_equal(tf["sp_feature"], jf["sp_feature"])
    tds.set_feature_flag(False)
    assert "sp_feature" not in tds.get_frame(1)

    outs = {}
    for name, mod, kw in (("jax", jpre, {}), ("port", tpre,
                                              {"device": "cpu"})):
        mod.gen_fusion(config, None, voxel_size=VOXEL, **kw)
        v = read_ply_vertices(tds.sparse_ply)
        outs[name] = (np.stack([v["x"], v["y"], v["z"]], -1),
                      np.load(tds.sparse_feature))
    m = _match(outs["port"][0], outs["jax"][0], 1e-4)
    assert _unmatched_ok(m, len(outs["jax"][0])) and (m >= 0).sum() > 100
    np.testing.assert_allclose(outs["port"][1][m >= 0],
                               outs["jax"][1][m[m >= 0]], rtol=0, atol=1e-4)

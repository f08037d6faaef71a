"""Port parity for the leaves nothing on the main path imports:
``data.colmap`` (text and binary models), ``data.grad_mask`` (the median of
an even count), ``fields.encoding`` (every ``get_encoder`` kind) and
``fields.autoencoder``, against the JAX package on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.data import colmap as jcolmap
from splatloc_tpu.data import grad_mask as jgrad
from splatloc_tpu.fields import autoencoder as jae
from splatloc_tpu.fields import encoding as jenc
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.data import colmap as tcolmap
from splatloc_tpu_torch.data import grad_mask as tgrad
from splatloc_tpu_torch.fields import autoencoder as tae
from splatloc_tpu_torch.fields import encoding as tenc

torch.set_num_threads(1)


def _model(mod, rng):
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 640, 480,
                                np.array([320.0, 321.0, 319.5, 239.5])),
            2: mod.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                np.array([160.0, 159.5, 119.5, 0.01]))}
    images = {}
    for i in (1, 2, 3):
        q = rng.normal(size=4)
        m = 3 * i
        images[i] = mod.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"frame_{i:04d}.png", rng.uniform(0, 640, (m, 2)),
            rng.integers(-1, 5, m))
    points = {7 + k: mod.ColmapPoint3D(
        7 + k, rng.normal(size=3), np.array([10, 200, 30 + k], np.uint8),
        0.5 + k, np.array([1, 2], np.int32), np.array([0, 2], np.int32))
        for k in range(3)}
    return cams, images, points


def _fields(model):
    return [[dataclasses.asdict(v) for _, v in sorted(part.items())]
            for part in model]


def _assert_same(a, b):
    for pa, pb in zip(_fields(a), _fields(b)):
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]))


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_colmap_round_trip_and_reads_match_jax(tmp_path, ext):
    """The port writes a model, reads it back and the JAX package reads
    the same files to the same fields; the other way round too."""
    rng = np.random.default_rng(0)
    model = _model(tcolmap, rng)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tdir.mkdir()
    jdir.mkdir()
    tcolmap.write_model(str(tdir), *model, ext=ext)
    back = tcolmap.read_model(str(tdir), ext)
    _assert_same(model, back)
    _assert_same(back, jcolmap.read_model(str(tdir), ext))
    assert tcolmap.read_model(str(tdir)) is not None      # auto-detected
    jcolmap.write_model(str(jdir), *_model(jcolmap, np.random.default_rng(
        0)), ext=ext)
    for name in ("cameras", "images", "points3D"):
        assert ((tdir / f"{name}{ext}").read_bytes()
                == (jdir / f"{name}{ext}").read_bytes())
    _assert_same(tcolmap.read_model(str(jdir), ext),
                 jcolmap.read_model(str(jdir), ext))


def test_colmap_pose_helpers_match_jax():
    rng = np.random.default_rng(1)
    model = _model(tcolmap, rng)
    jmodel = _model(jcolmap, np.random.default_rng(1))
    one_cam = {k: v for k, v in model[1].items() if v.camera_id == 2}
    j_one = {k: v for k, v in jmodel[1].items() if v.camera_id == 2}
    t_poses = tcolmap.model_to_poses(model[0], one_cam)
    j_poses = jcolmap.model_to_poses(jmodel[0], j_one)
    assert len(t_poses) == len(j_poses) == 4
    for a, b in zip(t_poses, j_poses):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="single shared camera"):
        tcolmap.model_to_poses(model[0], model[1])
    for q in rng.normal(size=(5, 4)):
        q = q / np.linalg.norm(q)
        R = tcolmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R),
                                      jcolmap.rotmat_to_qvec(R))
    xyz, rgb = tcolmap.points_array(model[2])
    jxyz, jrgb = jcolmap.points_array(jmodel[2])
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)


def _edge_image(seed=0):
    """480x640 with soft random edges and noise: many block medians sit
    between two distinct middle values."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.3, 0.35, (480, 640, 3)).astype(np.float32)
    rgb[:, 200:] += 0.3
    rgb[150:, :] += 0.2
    return np.clip(rgb, 0, 1).astype(np.float32)


@pytest.mark.parametrize("dataset_type", ["replica", "12scenes"])
def test_grad_mask_matches_jax(dataset_type):
    """At 480x640 the Replica blocks hold 300 values and the whole image
    307,200: both even, so the median averages the two middle ones, as
    jnp.median does. The mask is identical; the lower middle value
    (torch.median's) would change it."""
    rgb = _edge_image()
    j = np.asarray(jgrad.compute_grad_mask(jnp.asarray(rgb),
                                           dataset_type=dataset_type))
    t = tgrad.compute_grad_mask(torch.from_numpy(rgb),
                                dataset_type=dataset_type).numpy()
    assert t.shape == (480, 640)
    np.testing.assert_array_equal(t, j)
    assert 0.001 < t.mean() < 0.5
    x = torch.from_numpy(_edge_image(1)[:300, :1, 0].reshape(-1))
    assert float(tgrad._median(x)) != float(torch.median(x))
    assert float(tgrad._median(x)) == float(jnp.median(jnp.asarray(
        x.numpy())))


@pytest.mark.parametrize("name", ["HashGrid", "tiled", "dense", "spherical",
                                  "blob", "freq", "identity"])
def test_get_encoder_matches_jax(name):
    """Each encoder kind on the JAX package's params (converted): the same
    output dim and values within 1e-6 (1e-5 for the frequency encoder's
    sin/cos of arguments up to 2^11 pi)."""
    kw = dict(desired_resolution=64, n_levels=4, log2_hashmap_size=10)
    je, te = jenc.get_encoder(name, **kw), tenc.get_encoder(name, **kw)
    assert te.out_dim == je.out_dim and te.name == je.name
    jp = je.init(jax.random.PRNGKey(0))
    if name == "dense":
        jp = {"tables": [t * 1e3 for t in jp["tables"]]}
    elif "table" in jp:
        jp = {"table": jp["table"] * 1e3}
    tp = convert.encoder_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (64, 3)).astype(np.float32)
    j = np.asarray(je.apply(jp, jnp.asarray(x)))
    t = te.apply(tp, torch.from_numpy(x)).numpy()
    assert t.shape == (64, je.out_dim)
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=1e-5 if name == "freq" else 1e-6)
    # the port's own init has the JAX package's shapes
    own = te.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda a: tuple(a.shape), own)


def test_autoencoder_matches_jax():
    """encode, decode and forward on the JAX params (converted), within
    1e-6; the port's init has the same layer shapes."""
    kw = dict(encoder_dims=(64, 16), decoder_dims=(64, 64), in_dim=64)
    jp = jae.init_autoencoder(jax.random.PRNGKey(0), **kw)
    tp = convert.autoencoder_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    x = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
    for fn in ("encode", "forward"):
        j = np.asarray(getattr(jae, fn)(jp, jnp.asarray(x)))
        t = getattr(tae, fn)(tp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0,
                                   atol=1e-5)
    own = tae.init_autoencoder(torch.Generator().manual_seed(0), **kw,
                               device="cpu")
    assert [tuple(lay["w"].shape) for lay in own["enc"] + own["dec"]] == [
        tuple(np.shape(lay["w"])) for lay in jp["enc"] + jp["dec"]]

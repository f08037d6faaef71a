"""Port parity: scene.gaussians, scene.ply and convert against the JAX
package, and the port's ``render`` entry point against the JAX ``render``
dict (Pallas path in interpret mode on the CPU) at SH degrees 0 and 3."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import transforms as jtf
from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import render as jrender
from splatloc_tpu.raster.types import RasterConfig as JConfig
from splatloc_tpu.scene import ply as jply
from splatloc_tpu.scene.gaussians import GaussianScene as JScene
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.raster import render as trender
from splatloc_tpu_torch.raster import render_features as trender_features
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig
from splatloc_tpu_torch.scene import ply as tply
from splatloc_tpu_torch.scene.gaussians import GaussianScene as TScene

torch.set_num_threads(1)

W, H = 64, 48
CFG = dict(tile_size=16, use_pallas=True)
FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
          "marker", "kp_score", "alive")


def make_fields(rng, deg, n=300, capacity=320):
    """numpy fields of a scene with ``capacity`` slots, ``n`` of them
    alive, in the scene layout of the JAX package."""
    r = (deg + 1) ** 2 - 1
    xyz = np.stack([rng.uniform(-1.5, 1.5, capacity),
                    rng.uniform(-1, 1, capacity),
                    rng.uniform(1, 5, capacity)], -1).astype(np.float32)
    rgb = rng.uniform(0, 1, (capacity, 1, 3)).astype(np.float32)
    op = rng.uniform(0.2, 0.95, (capacity, 1))
    alive = np.zeros(capacity, bool)
    alive[rng.permutation(capacity)[:n]] = True
    fields = {
        "xyz": xyz,
        "f_dc": ((rgb - 0.5) / 0.28209479177387814).astype(np.float32),
        "scaling": rng.uniform(-4.5, -2.5, (capacity, 3)).astype(np.float32),
        "rotation": rng.normal(size=(capacity, 4)).astype(np.float32),
        "opacity": np.log(op / (1 - op)).astype(np.float32),
        "marker": rng.uniform(0, 1, (capacity, 1)).astype(np.float32),
        "kp_score": rng.uniform(0, 1, (capacity, 1)).astype(np.float32),
        "alive": alive,
    }
    # drawn last: the scenes of every degree share all other fields
    fields["f_rest"] = rng.normal(scale=0.1, size=(capacity, r, 3)).astype(
        np.float32)
    return fields


def jax_scene(fields, deg):
    return JScene(**{k: jnp.asarray(v) for k, v in fields.items()},
                  sh_degree=deg)


def _cams(rng):
    xi = rng.normal(scale=0.05, size=(6,)).astype(np.float32)
    w2c = np.asarray(jtf.se3_exp(jnp.asarray(xi)))
    args = (w2c, 50.0, 50.0, W / 2, H / 2, W, H)
    jc = JCamera.create(*args)
    tc = convert.camera_from_numpy(
        {k: np.asarray(getattr(jc, k)) for k in
         ("w2c", "fx", "fy", "cx", "cy", "width", "height", "znear",
          "zfar")}, device="cpu")
    return jc, tc


_jax_render = jax.jit(jrender, static_argnames=("cfg",))


def test_convert_round_trips_fields(rng):
    fields = make_fields(rng, 3)
    scene = convert.scene_from_numpy(fields, 3, device="cpu")
    assert scene.sh_degree == 3
    for k in FIELDS:
        got = getattr(scene, k)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), fields[k], err_msg=k)
    assert scene.alive.dtype == torch.bool
    with pytest.raises(ValueError, match="SH degree"):
        convert.scene_from_numpy(fields, 1, device="cpu")
    with pytest.raises(KeyError, match="alive"):
        convert.scene_from_numpy({k: v for k, v in fields.items()
                                  if k != "alive"}, 3, device="cpu")


def test_camera_from_numpy_matches_jax(rng):
    jc, tc = _cams(rng)
    for k in ("w2c", "fx", "fy", "cx", "cy", "tanfovx", "tanfovy",
              "camera_center"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-6,
                                   rtol=0, err_msg=k)
    assert (tc.width, tc.height) == (jc.width, jc.height)


@pytest.mark.parametrize("deg", [0, 3])
def test_scene_views_match_jax(rng, deg):
    fields = make_fields(rng, deg, n=40, capacity=48)
    js, ts = jax_scene(fields, deg), convert.scene_from_numpy(
        fields, deg, device="cpu")
    for name in ("scaling_activated", "opacity_activated",
                 "rotation_activated", "features"):
        np.testing.assert_allclose(getattr(ts, name)().numpy(),
                                   np.asarray(getattr(js, name)()),
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(ts.covariance(0.7).numpy(),
                               np.asarray(js.covariance(0.7)), atol=1e-6,
                               rtol=1e-5)
    assert int(ts.num_alive) == int(js.num_alive) == 40
    assert ts.capacity == 48
    assert set(ts.params()) == set(js.params()) == set(TScene.PARAM_FIELDS)
    moved = ts.with_params({"xyz": ts.xyz + 1.0})
    np.testing.assert_array_equal(moved.xyz.numpy(), fields["xyz"] + 1.0)
    np.testing.assert_array_equal(moved.f_dc.numpy(), fields["f_dc"])


@pytest.mark.parametrize("deg", [0, 3])
def test_empty_matches_jax(deg):
    te, je = TScene.empty(5, deg, device="cpu"), JScene.empty(5, deg)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(te, k).numpy(),
                                      np.asarray(getattr(je, k)), err_msg=k)


@pytest.mark.parametrize("deg", [0, 3])
def test_save_scene_bytes_match_jax(rng, tmp_path, deg):
    """The port writes the same bytes as the JAX writer, and each package
    reads the other's file back to the same alive Gaussians."""
    fields = make_fields(rng, deg, n=30, capacity=37)
    pj, pt = tmp_path / "jax.ply", tmp_path / "port.ply"
    jply.save_scene(jax_scene(fields, deg), str(pj))
    tply.save_scene(convert.scene_from_numpy(fields, deg, device="cpu"),
                    str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    assert tply.attribute_names(deg) == jply.attribute_names(deg)

    back = tply.load_scene(str(pj), deg, capacity=40, device="cpu")
    ref = jply.load_scene(str(pt), deg, capacity=40)
    alive = fields["alive"]
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
        if k != "alive":
            np.testing.assert_array_equal(getattr(back, k).numpy()[:30],
                                          fields[k][alive], err_msg=k)
    assert int(back.num_alive) == 30 and back.capacity == 40


def test_load_scene_rejects_mismatch(rng, tmp_path):
    path = tmp_path / "s.ply"
    tply.save_scene(convert.scene_from_numpy(make_fields(rng, 0, 10, 10), 0,
                                             device="cpu"), str(path))
    with pytest.raises(ValueError, match="SH degree"):
        tply.load_scene(str(path), 3, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tply.load_scene(str(path), 0, capacity=5, device="cpu")


@pytest.mark.parametrize("deg", [0, 3])
def test_render_matches_jax(rng, deg):
    """The port's render dict equals the JAX render dict, with the
    tolerances of test_pallas_forward_parity."""
    fields = make_fields(rng, deg)
    jc, tc = _cams(rng)
    bg = np.array([0.1, 0.2, 0.3, 0.0], np.float32)
    ref = _jax_render(jax_scene(fields, deg), jc, cfg=JConfig(**CFG),
                      bg=jnp.asarray(bg))
    got = trender(convert.scene_from_numpy(fields, deg, device="cpu"), tc,
                  TConfig(**CFG), bg=torch.from_numpy(bg))
    assert set(got) == set(ref)
    tol = {"render": 5e-5, "kp_prob": 5e-5, "opacity": 5e-5, "depth": 2e-4,
           "means2d": 1e-4}
    for k, atol in tol.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, rtol=0, err_msg=k)
    for k in ("radii", "visibility_filter"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["render"].shape == (H, W, 3)
    assert float(got["opacity"].max()) > 0.5
    # dead slots project to nothing
    assert not got["visibility_filter"].numpy()[~fields["alive"]].any()


def test_render_features_matches_jax(rng):
    """Multichannel compositing (K = 8 feature channels, unit range like
    the colors the tolerances were set for)."""
    from splatloc_tpu.raster import render_features as jrender_features
    fields = make_fields(rng, 0)
    feats = rng.uniform(0, 1, (len(fields["xyz"]), 8)).astype(np.float32)
    jc, tc = _cams(rng)
    ref = jax.jit(functools.partial(jrender_features,
                                    cfg=JConfig(**CFG)))(
        jax_scene(fields, 0), jc, jnp.asarray(feats))
    got = trender_features(convert.scene_from_numpy(fields, 0, device="cpu"),
                           tc, torch.from_numpy(feats), TConfig(**CFG))
    assert got["feature_map"].shape == (H, W, 8)
    for k, atol in (("feature_map", 5e-5), ("opacity", 5e-5),
                    ("depth", 2e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_raster_config_fields_match_jax():
    """One configuration means the same render in both packages."""
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert tf == jf

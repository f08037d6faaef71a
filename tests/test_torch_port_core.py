"""Port parity: core.transforms, core.camera and core.sh against the JAX
package on the same numpy inputs (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import camera as jcamera
from splatloc_tpu.core import sh as jsh
from splatloc_tpu.core import transforms as jtf
from splatloc_tpu_torch.core import camera as tcamera
from splatloc_tpu_torch.core import sh as tsh
from splatloc_tpu_torch.core import transforms as ttf

torch.set_num_threads(1)

ATOL = 1e-6


def _j(fn, *args):
    return np.asarray(fn(*map(jnp.asarray, args)))


def _t(fn, *args):
    return fn(*(torch.from_numpy(np.array(a)) for a in args)).numpy()


def _quats(rng, n=16):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q


def _rotations(rng, n=16):
    q = _quats(rng, n)
    return np.asarray(jtf.quat_to_matrix(jnp.asarray(q)))


@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_matrix"])
def test_quat_unary(rng, name):
    q = _quats(rng)
    np.testing.assert_allclose(_t(getattr(ttf, name), q),
                               _j(getattr(jtf, name), q), atol=ATOL)


def test_matrix_to_quat_all_branches(rng):
    R = _rotations(rng, 64)
    # rotations by ~pi about each axis force the three non-trace branches
    for ax in range(3):
        w = np.zeros((1, 3), np.float32)
        w[0, ax] = 3.1
        R = np.concatenate([R, np.asarray(jtf.so3_exp(jnp.asarray(w)))])
    np.testing.assert_allclose(_t(ttf.matrix_to_quat, R),
                               _j(jtf.matrix_to_quat, R), atol=ATOL)


@pytest.mark.parametrize("name", ["quat_multiply", "quat_angle_deg"])
def test_quat_binary(rng, name):
    a, b = _quats(rng), _quats(rng)
    atol = 1e-4 if name == "quat_angle_deg" else ATOL   # degrees via arccos
    np.testing.assert_allclose(_t(getattr(ttf, name), a, b),
                               _j(getattr(jtf, name), a, b), atol=atol)


def test_rotation_6d_and_skew(rng):
    d6 = rng.normal(size=(16, 6)).astype(np.float32)
    np.testing.assert_allclose(_t(ttf.rotation_6d_to_matrix, d6),
                               _j(jtf.rotation_6d_to_matrix, d6), atol=ATOL)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(_t(ttf.skew, v), _j(jtf.skew, v))


def _twists(rng):
    xi = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    xi[0] = 0.0                       # the Taylor branch at theta = 0
    xi[1, 3:] = 1e-8
    return xi


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp"])
def test_exp_maps(rng, name):
    xi = _twists(rng)
    x = xi[:, 3:] if name == "so3_exp" else xi
    np.testing.assert_allclose(_t(getattr(ttf, name), x),
                               _j(getattr(jtf, name), x),
                               rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("name", ["so3_log", "se3_log"])
def test_log_maps(rng, name):
    xi = _twists(rng)
    T = np.asarray(jtf.se3_exp(jnp.asarray(xi)))
    x = T[:, :3, :3] if name == "so3_log" else T
    np.testing.assert_allclose(_t(getattr(ttf, name), x),
                               _j(getattr(jtf, name), x),
                               rtol=1e-5, atol=1e-5)


def test_invert_and_transform_points(rng):
    T = np.asarray(jtf.se3_exp(jnp.asarray(_twists(rng))))
    np.testing.assert_allclose(_t(ttf.invert_se3, T), _j(jtf.invert_se3, T),
                               atol=ATOL)
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(_t(ttf.transform_points, T, pts),
                               _j(jtf.transform_points, T, pts), atol=1e-5)


def _cameras(rng):
    xi = rng.normal(scale=0.3, size=(6,)).astype(np.float32)
    w2c = np.asarray(jtf.se3_exp(jnp.asarray(xi)))
    args = (w2c, 120.5, 118.0, 80.25, 61.0, 160, 120)
    return (jcamera.Camera.create(*args),
            tcamera.Camera.create(*args, device="cpu"))


def test_camera_properties(rng):
    jc, tc = _cameras(rng)
    for name in ("c2w", "camera_center", "tanfovx", "tanfovy", "K"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=ATOL,
                                   err_msg=name)
    assert (tc.width, tc.height, tc.znear, tc.zfar) == (
        jc.width, jc.height, jc.znear, jc.zfar)


def test_camera_project_backproject(rng):
    jc, tc = _cameras(rng)
    pts = np.stack([rng.uniform(-1, 1, 32), rng.uniform(-1, 1, 32),
                    rng.uniform(1, 4, 32)], -1).astype(np.float32)
    pts_w = np.asarray(jtf.transform_points(jtf.invert_se3(jc.w2c),
                                            jnp.asarray(pts)))
    uv_j, z_j = jc.project(jnp.asarray(pts_w))
    uv_t, z_t = tc.project(torch.from_numpy(pts_w))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)
    back_j = jc.backproject(uv_j, z_j)
    back_t = tc.backproject(torch.from_numpy(np.asarray(uv_j)),
                            torch.from_numpy(np.asarray(z_j)))
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), atol=1e-5)


def test_camera_replace_pose(rng):
    jc, tc = _cameras(rng)
    w2c = np.asarray(jtf.se3_exp(jnp.asarray(
        rng.normal(scale=0.2, size=(6,)).astype(np.float32))))
    np.testing.assert_allclose(
        tc.replace_pose(torch.from_numpy(w2c)).camera_center.numpy(),
        np.asarray(jc.replace_pose(jnp.asarray(w2c)).camera_center),
        atol=ATOL)
    assert tc.replace_pose(torch.from_numpy(w2c)).fx is tc.fx


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(rng, deg):
    sh = rng.normal(size=(32, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))),
        atol=ATOL)


@pytest.mark.parametrize("deg", [0, 3])
def test_sh_to_color(rng, deg):
    sh = rng.normal(scale=0.5, size=(64, 3, (deg + 1) ** 2)).astype(
        np.float32)
    means = rng.normal(size=(64, 3)).astype(np.float32)
    campos = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_allclose(
        _t(lambda *a: tsh.sh_to_color(deg, *a), sh, means, campos),
        _j(lambda *a: jsh.sh_to_color(deg, *a), sh, means, campos),
        atol=ATOL)


def test_rgb_sh_roundtrip(rng):
    rgb = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(_t(tsh.rgb_to_sh, rgb), _j(jsh.rgb_to_sh, rgb),
                               atol=ATOL)
    sh = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(_t(tsh.sh_to_rgb, sh), _j(jsh.sh_to_rgb, sh),
                               atol=ATOL)


def test_se3_exp_gradient_matches_jax(rng):
    """Autograd through the exp map (the pose-refinement update) agrees
    with jax.grad, including the NaN-safe point xi = 0."""
    for xi in (np.zeros(6, np.float32),
               rng.normal(scale=0.3, size=(6,)).astype(np.float32)):
        w = rng.normal(size=(4, 4)).astype(np.float32)
        gj = jax.grad(lambda x: jnp.sum(jtf.se3_exp(x) * w))(jnp.asarray(xi))
        xt = torch.from_numpy(xi.copy()).requires_grad_(True)
        torch.sum(ttf.se3_exp(xt) * torch.from_numpy(w)).backward()
        assert torch.isfinite(xt.grad).all()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj),
                                   rtol=1e-5, atol=1e-5)

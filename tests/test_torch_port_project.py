"""Port parity: raster.project.project_gaussians and build_cov3d against the
JAX package on the same numpy inputs (CPU), culled points included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import transforms as jtf
from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import project as jproject
from splatloc_tpu.raster.types import RasterConfig as JConfig
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.raster import project as tproject
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig

torch.set_num_threads(1)

W, H = 64, 48
FIELDS = ("u", "v", "depth", "conic_a", "conic_b", "conic_c", "radius",
          "radius_x", "radius_y")


def make_scene(rng, n=300):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    # culled cases: behind the camera, inside the near plane, and far off
    # screen (zero tile rect)
    means[0] = [0.0, 0.0, -2.0]
    means[1] = [0.1, 0.0, 0.1]
    means[2] = [40.0, 0.0, 2.0]
    means[3] = [0.0, -30.0, 1.5]
    scales = np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(np.float32)
    scales[4] = [0.8, 0.02, 0.3]          # strongly anisotropic
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.02, 0.95, n).astype(np.float32)
    opac[5] = 0.003                       # below alpha_min: empty AABB
    return means, scales, quats, opac


def _pose(rng):
    xi = rng.normal(scale=0.05, size=(6,)).astype(np.float32)
    return np.asarray(jtf.se3_exp(jnp.asarray(xi)))


def _cams(w2c):
    args = (w2c, 50.0, 52.0, W / 2 + 0.3, H / 2 - 0.2, W, H)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def _compare(pj, pt):
    np.testing.assert_array_equal(pt.visible.numpy(), np.asarray(pj.visible))
    for f in FIELDS:
        a = np.asarray(getattr(pj, f))
        b = getattr(pt, f).detach().numpy()
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, rtol=0,
                                   err_msg=f)


CASES = {
    "aabb_opac": dict(cfg=dict(aabb_binning=True), opac=True),
    "aabb_no_opac": dict(cfg=dict(aabb_binning=True), opac=False),
    "square_opac": dict(cfg=dict(aabb_binning=False), opac=True),
    "square_no_opac": dict(cfg=dict(aabb_binning=False), opac=False),
    "alive": dict(cfg={}, opac=True, alive=True),
    "scaling_modifier": dict(cfg={}, opac=True, mod=0.6),
    "blur_near": dict(cfg=dict(cov2d_blur=0.1, near=0.5), opac=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_project_gaussians_parity(rng, case):
    spec = CASES[case]
    means, scales, quats, opac = make_scene(rng)
    jc, tc = _cams(_pose(rng))
    alive = (np.arange(len(means)) % 3 != 0) if spec.get("alive") else None
    kw_j = dict(scaling_modifier=spec.get("mod", 1.0))
    kw_t = dict(kw_j)
    if alive is not None:
        kw_j["alive"] = jnp.asarray(alive)
        kw_t["alive"] = torch.from_numpy(alive)
    if spec["opac"]:
        kw_j["opacities"] = jnp.asarray(opac)
        kw_t["opacities"] = torch.from_numpy(opac)
    pj = jproject.project_gaussians(
        *map(jnp.asarray, (means, scales, quats)), jc,
        JConfig(**spec["cfg"]), **kw_j)
    pt = tproject.project_gaussians(
        *map(torch.from_numpy, (means, scales, quats)), tc,
        TConfig(**spec["cfg"]), **kw_t)
    _compare(pj, pt)
    vis = np.asarray(pj.visible)
    assert not vis[:4].any()              # the culled cases are culled
    assert vis.sum() > 100


def test_build_cov3d(rng):
    _, scales, quats, _ = make_scene(rng, 64)
    a = np.asarray(jproject.build_cov3d(jnp.asarray(scales),
                                        jnp.asarray(quats)))
    b = tproject.build_cov3d(torch.from_numpy(scales),
                             torch.from_numpy(quats)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-7)


def test_projection_gradients_match_jax(rng):
    """Gradients through the projection (to every Gaussian parameter and
    the camera pose) are ordinary autograd and agree with jax.grad."""
    means, scales, quats, opac = make_scene(rng, 120)
    w2c = _pose(rng)
    wts = rng.normal(size=(6, len(means))).astype(np.float32)

    def loss_j(m, s, q, pose):
        cam = JCamera.create(pose, 50.0, 52.0, W / 2, H / 2, W, H)
        p = jproject.project_gaussians(m, s, q, cam, JConfig(),
                                       opacities=jnp.asarray(opac))
        vis = p.visible.astype(jnp.float32)
        comps = (p.u, p.v, p.conic_a, p.conic_b, p.conic_c, p.depth)
        return sum(jnp.sum(w * c * vis) for w, c in zip(wts, comps))

    def loss_t(m, s, q, pose):
        cam = TCamera(w2c=pose, fx=torch.tensor(50.0), fy=torch.tensor(52.0),
                      cx=torch.tensor(W / 2), cy=torch.tensor(H / 2),
                      width=W, height=H)
        p = tproject.project_gaussians(m, s, q, cam, TConfig(),
                                       opacities=torch.from_numpy(opac))
        vis = p.visible.to(torch.float32)
        comps = (p.u, p.v, p.conic_a, p.conic_b, p.conic_c, p.depth)
        return sum(torch.sum(torch.from_numpy(w) * c * vis)
                   for w, c in zip(wts, comps))

    args = (means, scales, quats, w2c)
    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    loss_t(*ts).backward()
    for i, (a, t) in enumerate(zip(gj, ts)):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(t.grad.numpy(), a, atol=2e-5 * scale,
                                   rtol=1e-4, err_msg=f"grad arg {i}")

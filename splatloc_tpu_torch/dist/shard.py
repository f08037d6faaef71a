"""Mesh sharding of the mapping step over ``torch.distributed``.

Port of ``splatloc_tpu.dist.shard``. The JAX package declares shardings
and lets XLA's SPMD partitioner insert the collectives; here they are
written out. A mesh has two axes:

- ``data``  - keyframe views (data parallel): each ``data`` rank renders
  its share of the window's views (view v on rank v % data) and sums their
  losses; gradients and the densify-statistic increments are summed over
  ``data``, the visibility union and the largest radii taken as maxima.
- ``gauss`` - the Gaussian axis: each rank holds its block of rows of the
  scene, the Adam moments and the densify statistics. The full parameters
  are all-gathered for rendering, and Adam steps the rank's rows of the
  summed gradient.

The loss of a mapping step is a sum over views plus one isotropic term
(added on ``data`` rank 0 only), so the split computes the unsharded
step's result up to the order of the sums. Every reduction runs in a fixed
order: two runs agree bit for bit.
"""
from __future__ import annotations

import math

import torch

from splatloc_tpu_torch.dist.multihost import Mesh, mesh_of
from splatloc_tpu_torch.scene import densify, optim
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train import losses, mapping

# the per-Gaussian leaves of a scene
SCENE_FIELDS = GaussianScene.PARAM_FIELDS + ("alive",)
STATS_FIELDS = ("xyz_gradient_accum", "denom", "max_radii2d")


def make_mesh(data: int = 1, gauss: int = 1, ranks=None) -> Mesh:
    """A (data, gauss) mesh over the first data * gauss of ``ranks``
    (default: every rank, in rank order). Collective: every process of the
    default group calls it."""
    return mesh_of({"data": data, "gauss": gauss}, ranks)


def _rows(mesh: Mesh, n: int) -> slice:
    """This rank's block of ``n`` rows over the ``gauss`` axis."""
    G = mesh.shape["gauss"]
    if n % G:
        raise ValueError(f"{n} rows do not split over {G} gauss ranks")
    k = n // G
    g = mesh.index("gauss")
    return slice(g * k, (g + 1) * k)


def scene_sharding(mesh: Mesh, scene: GaussianScene) -> dict:
    """field -> the slice of its leading (Gaussian) axis this rank holds:
    its block of rows over ``gauss``."""
    sl = _rows(mesh, scene.capacity)
    return {k: sl for k in SCENE_FIELDS}


def frames_sharding(mesh: Mesh, frames: dict) -> dict:
    """key -> the slice of the window's leading (view) axis this rank
    renders: views r, r + data, ... for ``data`` rank r."""
    sl = slice(mesh.index("data"), None, mesh.shape["data"])
    return {k: sl for k in frames}


def shard_scene(mesh: Mesh, scene: GaussianScene) -> GaussianScene:
    """This rank's ``gauss`` shard of the scene."""
    return scene.replace(**{k: getattr(scene, k)[sl] for k, sl in
                            scene_sharding(mesh, scene).items()})


def shard_state(mesh: Mesh, opt_state: optim.AdamState,
                stats: densify.DensifyStats):
    """This rank's ``gauss`` shards of the Adam state (the step counter is
    shared) and of the densify statistics."""
    sl = _rows(mesh, stats.denom.shape[0])
    return (opt_state.replace(m={k: x[sl] for k, x in opt_state.m.items()},
                              v={k: x[sl] for k, x in opt_state.v.items()}),
            stats.replace(**{k: getattr(stats, k)[sl]
                             for k in STATS_FIELDS}))


def _pack(tensors) -> torch.Tensor:
    """[n, ...] tensors as the float32 columns of one [n, k] tensor, for one
    collective instead of one each (float32, int32 < 2^24 and bool values
    come back exactly)."""
    return torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                      for t in tensors], 1)


def _unpack(buf: torch.Tensor, like) -> list:
    """The inverse of _pack with ``buf``'s row count: tensors shaped and
    typed as ``like`` past their leading axis."""
    out, c = [], 0
    for t in like:
        k = math.prod(t.shape[1:])
        out.append(buf[:, c:c + k].reshape((buf.shape[0],) + t.shape[1:])
                   .to(t.dtype).contiguous())
        c += k
    return out


def gather_scene(mesh: Mesh, scene: GaussianScene) -> GaussianScene:
    """The whole scene from every rank's ``gauss`` shard, on every rank."""
    like = [getattr(scene, k) for k in SCENE_FIELDS]
    full = _unpack(mesh.all_gather(_pack(like), "gauss"), like)
    return scene.replace(**dict(zip(SCENE_FIELDS, full)))


def make_sharded_mapping_step(cfg: mapping.MappingConfig, mesh: Mesh):
    """The mapping step of ``train.mapping.make_mapping_step`` over a
    (data, gauss) mesh. The step takes this rank's ``gauss`` shards of the
    scene, the Adam state and the densify statistics (shard_scene,
    shard_state) and the whole window of frames, of which it renders its
    ``data`` share (frames_sharding; the window needs at least ``data``
    views). It returns make_mapping_step's tuple (scene, opt_state, stats,
    loss, vis_union, n_dropped [dropped, trunc, vis_overflow]) with the
    per-Gaussian leaves holding this rank's shard; loss and counters are the
    whole window's, the same on every rank."""
    camera = mapping._camera_cache(cfg)

    def step_fn(scene: GaussianScene, opt_state: optim.AdamState,
                stats: densify.DensifyStats, frames: dict, step):
        if frames["w2c"].shape[0] < mesh.shape["data"]:
            raise ValueError(f"{frames['w2c'].shape[0]} views over "
                             f"{mesh.shape['data']} data ranks")
        full = gather_scene(mesh, scene)
        M = full.capacity
        dev = full.xyz.device
        base = camera(dev)
        sh = frames_sharding(mesh, frames)
        frames = {k: x[sh[k]] for k, x in frames.items()}
        V = frames["w2c"].shape[0]
        params = {k: p.detach().requires_grad_(True)
                  for k, p in full.params().items()}
        offsets = torch.zeros((V, M, 2), device=dev, requires_grad=True)
        sc = full.with_params(params)
        ls, radii, ndrop, ntrunc, nvis = [], [], [], [], []
        for v in range(V):
            frame = {k: x[v] for k, x in frames.items()}
            out = mapping._render_view(sc, frame, offsets[v], cfg, base)
            gt_rgb = frame["rgb"].to(torch.float32) / 255.0
            gt_depth = frame["depth_mm"].to(torch.float32) / 1000.0
            gt_score = frame["score"].to(torch.float32)
            l = losses.mapping_loss(out.image[..., :3], out.depth, gt_rgb,
                                    gt_depth, frame["exposure"][0],
                                    frame["exposure"][1],
                                    cfg.rgb_boundary_threshold)
            ls.append(l + losses.marker_loss(out.image[..., 3], gt_score))
            radii.append(out.radii)
            ndrop.append(out.n_dropped)
            ntrunc.append(out.n_trunc)
            nvis.append(out.n_vis_dropped)
        loss = torch.sum(torch.stack(ls))
        if cfg.primitive_reg and mesh.index("data") == 0:
            iso = losses.isotropic_loss(torch.exp(params["scaling"]),
                                        params["marker"][:, 0], full.alive,
                                        cfg.marker_thresh)
            loss = loss + cfg.isotropic_weight * iso
        *grads, off_grads = torch.autograd.grad(
            loss, list(params.values()) + [offsets], allow_unused=True)
        grads = mapping._finish_grads(full, params, grads, cfg)
        radii = torch.stack(radii)
        inc = densify.DensifyStats.zeros(M, dev)
        for v in range(V):
            inc = densify.add_stats(inc, off_grads[v], radii[v], cfg.width,
                                    cfg.height)
        vis = torch.any(radii > 0, dim=0)

        # over data: sums of the gradients and the additive increments,
        # maxima of the radii and the visibility, the counters as the
        # unsharded step combines its views'
        summed = [*grads.values(), inc.xyz_gradient_accum, inc.denom]
        summed = _unpack(mesh.all_reduce(_pack(summed), "data"), summed)
        maxed = [inc.max_radii2d, vis]
        maxed = _unpack(mesh.all_reduce(_pack(maxed), "data", "max"), maxed)
        counts = mesh.all_reduce(torch.stack(
            [torch.stack(ndrop).sum(), torch.stack(ntrunc).sum()]).to(
                torch.int64), "data")
        vis_over = mesh.all_reduce(torch.stack(nvis).max().to(torch.int64),
                                   "data", "max")
        loss = mesh.all_reduce(loss.detach(), "data")

        # over gauss: this rank's rows
        sl = _rows(mesh, M)
        g_sh = {k: g[sl] for k, g in zip(grads, summed)}
        acc_inc, denom_inc = summed[-2][sl], summed[-1][sl]
        stats = stats.replace(
            xyz_gradient_accum=stats.xyz_gradient_accum + acc_inc,
            denom=stats.denom + denom_inc,
            max_radii2d=torch.maximum(stats.max_radii2d, maxed[0][sl]))
        lrs = optim.make_lrs(cfg.opt_lr_dict(), cfg.spatial_lr_scale, step)
        new_params, opt_state = optim.update(scene.params(), g_sh,
                                             opt_state, lrs)
        n_dropped = torch.cat([counts, vis_over[None]])
        return (scene.with_params(new_params), opt_state, stats, loss,
                maxed[1][sl], n_dropped)

    return step_fn

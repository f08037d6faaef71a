"""Port parity for descriptor-field training: the hash grid's one-gather
``encode`` (its forward, its table gradient and its autograd graph),
``train.decoder_train``'s Adam step and epochs, and ``cli.train_decoder``,
against the JAX package on the same numpy inputs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from splatloc_tpu.fields import decoder as jdecoder
from splatloc_tpu.fields import hashgrid as jhash
from splatloc_tpu.train import decoder_train as jtrain
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.cli import train_decoder as tcli
from splatloc_tpu_torch.fields import decoder as tdecoder
from splatloc_tpu_torch.fields import hashgrid as thash
from splatloc_tpu_torch.scene.ply import write_ply
from splatloc_tpu_torch.train import decoder_train as ttrain

torch.set_num_threads(1)

# 16 levels: 0-11 dense ((res+1)^3 <= 2^12), 12-15 hashed
GRID16 = dict(n_levels=16, n_features=2, base_resolution=2,
              log2_hashmap_size=12, desired_resolution=30)
SMALL_GRID = dict(n_levels=4, n_features=2, base_resolution=4,
                  log2_hashmap_size=10, desired_resolution=32)
# aten ops of one forward and backward of encode at batch 256 (100 on a
# 16-level grid); the one-gather-per-level-and-corner form took 3,683
ENCODE_OP_CEILING = 150
# relative L2 of the gradients and params after one Adam step and after 3
# epochs. Both packages round the MLP's operands and both matmul
# cotangents to bf16 after float32 sums taken in different orders, so an
# isolated value lands one bf16 ulp (2^-8 relative) away: measured 5e-5
# (one step's table gradient) and 3e-4 (the table after three epochs),
# against updates of ~1 % of the params a step
STEP_REL_L2 = 1e-3
EPOCH_REL_L2 = 2e-3
LOSS_TOL = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_grid16_has_dense_and_hashed_levels():
    cfg = thash.HashGridConfig(**GRID16)
    dense = [(r + 1) ** 3 <= cfg.table_size for r in cfg.resolutions]
    assert dense == [True] * 12 + [False] * 4, cfg.resolutions


@pytest.mark.parametrize("grid", ["grid16", "room0"])
def test_encode_forward_is_the_per_level_order(grid):
    """One gather for all levels and corners gives the per-level loop's
    bits (the corners summed 0..7 from zeros, as JAX sums them), and
    agrees with JAX's encode within 1e-6."""
    kw = GRID16 if grid == "grid16" else dict(desired_resolution=133)
    tcfg, jcfg = thash.HashGridConfig(**kw), jhash.HashGridConfig(**kw)
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, (tcfg.n_levels, tcfg.table_size,
                                tcfg.n_features)).astype(np.float32)
    pos = rng.uniform(-0.05, 1.05, (256, 3)).astype(np.float32)
    t_table, t_pos = torch.from_numpy(table), torch.from_numpy(pos)
    got = thash.encode(t_table, t_pos, tcfg)
    assert torch.equal(got, thash.encode_per_level(t_table, t_pos, tcfg))
    j = np.asarray(jhash.encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    np.testing.assert_allclose(got.numpy(), j, rtol=0, atol=1e-6)


def test_encode_table_gradient_matches_jax():
    """The table's gradient under a seeded cotangent, within 1e-5 relative
    and 1e-6 absolute of JAX's (the contributions to an entry, up to a few
    units, are summed in another order)."""
    tcfg, jcfg = (thash.HashGridConfig(**GRID16),
                  jhash.HashGridConfig(**GRID16))
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (16, tcfg.table_size, 2)).astype(np.float32)
    pos = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    ct = rng.normal(size=(256, tcfg.out_dim)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jhash.encode(t, jnp.asarray(pos), jcfg)
                                    * ct))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (thash.encode(t, torch.from_numpy(pos), tcfg)
     * torch.from_numpy(ct)).sum().backward()
    assert float(np.abs(np.asarray(jg)).max()) > 0.1
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _graph_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        g = stack.pop()
        if g is None or g in seen:
            continue
        seen.add(g)
        stack += [n for n, _ in g.next_functions]
    return {type(g).__name__ for g in seen}


def test_encode_backward_is_one_gather():
    """room_0's grid (16 x 2^19) at batch 256: the graph holds one gather
    (hashgrid._TableGather) and no per-corner SelectBackward0, each of
    which zero-filled the whole table; the ops stay under the ceiling."""
    cfg = thash.HashGridConfig(desired_resolution=133)
    table = torch.zeros((16, cfg.table_size, 2), requires_grad=True)
    pos = torch.rand((256, 3), generator=torch.Generator().manual_seed(2))
    with _OpCount() as count:
        out = thash.encode(table, pos, cfg)
        nodes = _graph_nodes(out)
        out.backward(torch.ones_like(out))
    assert "SelectBackward0" not in nodes, nodes
    assert "_TableGatherBackward" in nodes, nodes
    assert count.n <= ENCODE_OP_CEILING, count.n
    # every level's 8 corners took weight from the batch
    assert float(table.grad.abs().sum()) == pytest.approx(256 * 16 * 2,
                                                          rel=1e-5)


def _field_cfgs():
    kw = dict(bound=((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)), num_layers=3,
              hidden_dim=32, final_dim=16)
    return (jdecoder.FeatureFieldConfig(
                **kw, grid=jhash.HashGridConfig(**SMALL_GRID)),
            tdecoder.FeatureFieldConfig(
                **kw, grid=thash.HashGridConfig(**SMALL_GRID)))


def _cloud(n=512, seed=0):
    """Points in the bound labelled with one of 4 unit directions by
    quadrant (tests/test_fields.py's field)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(4, 16)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    labels = (xyz[:, 0] > 0).astype(int) * 2 + (xyz[:, 1] > 0).astype(int)
    return xyz, dirs[labels]


def _params():
    """The same params for both sides: JAX's init layers and a table of
    trained scale (uniform +-0.1)."""
    jcfg, _ = _field_cfgs()
    jp = jdecoder.init_decoder(jcfg, jax.random.PRNGKey(0))
    table = np.random.default_rng(3).uniform(
        -0.1, 0.1, np.asarray(jp["table"]).shape).astype(np.float32)
    return {"table": table, "layers": [np.asarray(w) for w in jp["layers"]]}


def _jax_params(p):
    return {"table": jnp.asarray(p["table"]),
            "layers": [jnp.asarray(w) for w in p["layers"]]}


def _port_params(p):
    out = convert.decoder_from_numpy(p, device="cpu")
    for t in [out["table"], *out["layers"]]:
        t.requires_grad_(True)
    return out


def test_one_adam_step_matches_jax():
    """Gradients and one step of the per-group Adam (weight decay on the
    layers, eps 1e-15 on the table) against optax's."""
    jcfg, tcfg = _field_cfgs()
    xyz, feats = _cloud()
    p = _params()
    x, f = xyz[:64], feats[:64]
    jp = _jax_params(p)
    opt = jtrain.make_optimizer()
    jl, jg = jax.value_and_grad(lambda q: jdecoder.cosine_loss(
        jdecoder.decode(q, jnp.asarray(x), jcfg), jnp.asarray(f)))(jp)
    upd, _ = opt.update(jg, opt.init(jp), jp)
    jp1 = optax.apply_updates(jp, upd)

    tp = _port_params(p)
    topt = ttrain.make_optimizer(tp)
    loss = ttrain.train_step(tp, topt, torch.from_numpy(x),
                             torch.from_numpy(f), tcfg)
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    assert _rel_l2(jg["table"], tp["table"].grad) < STEP_REL_L2
    for a, b in zip(jg["layers"], tp["layers"]):
        assert _rel_l2(a, b.grad) < STEP_REL_L2
    assert _rel_l2(jp1["table"], tp["table"].detach()) < STEP_REL_L2
    for a, b in zip(jp1["layers"], tp["layers"]):
        assert _rel_l2(a, b.detach()) < STEP_REL_L2


def test_three_epochs_match_jax():
    """Three epochs from the same params over the same seeded batches: the
    per-epoch loss and the trained params against JAX's train_decoder."""
    jcfg, tcfg = _field_cfgs()
    xyz, feats = _cloud()
    p = _params()
    # the per-epoch losses through each package's epoch function
    rng = np.random.default_rng(0)
    perms = [rng.permutation(512).reshape(8, 64) for _ in range(3)]
    jp = _jax_params(p)
    opt = jtrain.make_optimizer()
    state = opt.init(jp)
    jepoch = jtrain.make_train_epoch(jcfg, opt)
    tp = _port_params(p)
    tepoch = ttrain.make_train_epoch(tcfg, ttrain.make_optimizer(tp), tp)
    for perm in perms:
        jp, state, jl = jepoch(jp, state, jnp.asarray(xyz),
                               jnp.asarray(feats), jnp.asarray(perm))
        tl = tepoch(torch.from_numpy(xyz), torch.from_numpy(feats),
                    torch.from_numpy(perm))
        assert float(tl) == pytest.approx(float(jl), abs=LOSS_TOL)
    # the whole train_decoder (the same draws: default_rng(seed))
    jout, jloss = jtrain.train_decoder(jcfg, xyz, feats, num_epochs=3,
                                       batch=64, log_every=0,
                                       params=_jax_params(p))
    tout, tloss = ttrain.train_decoder(tcfg, xyz, feats, num_epochs=3,
                                       batch=64, log_every=0,
                                       params=_port_params(p), device="cpu")
    assert tloss == pytest.approx(jloss, abs=LOSS_TOL)
    # training moved the params far more than the two packages differ
    assert _rel_l2(p["table"], tout["table"]) > 10 * EPOCH_REL_L2
    assert _rel_l2(jout["table"], tout["table"]) < EPOCH_REL_L2
    for a, b in zip(jout["layers"], tout["layers"]):
        assert _rel_l2(a, b) < EPOCH_REL_L2
    assert not tout["table"].requires_grad


def test_decoder_training_fits_field():
    """The field memorizes the descriptors of a small point cloud (the
    port's counterpart of tests/test_fields.py's test, from a generator)."""
    _, tcfg = _field_cfgs()
    xyz, feats = _cloud(seed=5)
    params, loss = ttrain.train_decoder(tcfg, xyz, feats, num_epochs=30,
                                        batch=128, log_every=0, device="cpu")
    assert loss < 0.05, loss
    rng = np.random.default_rng(6)
    test = xyz[:32] + rng.normal(0, 0.01, (32, 3)).astype(np.float32)
    pred = tdecoder.decode(params, torch.from_numpy(test), tcfg).numpy()
    assert (pred * feats[:32]).sum(-1).mean() > 0.9


def test_train_decoder_cli_run(tmp_path, capsys):
    """cli.train_decoder on a fused cloud in the generated folder: the
    checkpoint (the JAX layout, which the JAX package loads) and the loss
    lines."""
    root = tmp_path / "replica" / "room"
    gen = tmp_path / "generated" / "room"
    gen.mkdir(parents=True)
    (root / "Sequence_1" / "rgb").mkdir(parents=True)
    np.savetxt(root / "Sequence_1" / "traj_w_c.txt",
               np.eye(4).reshape(1, 16))
    xyz, feats = _cloud(n=300, seed=7)
    write_ply(str(gen / "sp_inloc_pc.ply"), ["x", "y", "z"], xyz)
    np.save(gen / "sp_inloc_feat.npy", feats)
    config = {"Dataset": {"type": "replica", "dataset_path": str(root),
                          "generated_folder": str(tmp_path / "generated"),
                          "Calibration": dict(fx=40.0, fy=40.0, cx=32.0,
                                              cy=24.0, width=64, height=48)},
              "scene": {"bound": [[-1, 1], [-1, 1], [-1, 1]],
                        "voxel_sdf": 0.2},
              "decoder": {"num_layers": 2, "hidden_dim": 32,
                          "final_dim": 16}}
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    save_dir = str(tmp_path / "out")
    out = tcli.run(config, save_dir, num_epochs=2, device="cpu")
    assert out == os.path.join(save_dir, "train_feat", "ckpt.npz")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("decoder epoch 0: cos loss ")
    assert lines[1].startswith("decoder epoch 1: cos loss ")
    jp = jtrain.load_params(out)
    g = tdecoder.FeatureFieldConfig.from_config(config).grid_config
    assert jp["table"].shape == (g.n_levels, g.table_size, g.n_features)
    assert [w.shape for w in jp["layers"]] == [(g.out_dim, 32), (32, 16)]

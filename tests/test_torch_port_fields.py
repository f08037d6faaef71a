"""Port parity for the descriptor field (fields.hashgrid, fields.decoder,
train.decoder_train's checkpoints, convert.decoder_from_numpy) against the
JAX package on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.fields import decoder as jdecoder
from splatloc_tpu.fields import hashgrid as jhash
from splatloc_tpu.train import decoder_train as jtrain
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.cli.config import load_config
from splatloc_tpu_torch.fields import decoder as tdecoder
from splatloc_tpu_torch.fields import hashgrid as thash
from splatloc_tpu_torch.train import decoder_train as ttrain

torch.set_num_threads(1)

# levels 0-1 dense ((res+1)^3 <= 1024), levels 2-3 hashed
SMALL_GRID = dict(n_levels=4, n_features=2, base_resolution=4,
                  log2_hashmap_size=10, desired_resolution=32)


def _grid_pair(kw):
    return jhash.HashGridConfig(**kw), thash.HashGridConfig(**kw)


def test_small_grid_has_dense_and_hashed_levels():
    cfg = thash.HashGridConfig(**SMALL_GRID)
    dense = [(r + 1) ** 3 <= cfg.table_size for r in cfg.resolutions]
    assert dense == [True, True, False, False], cfg.resolutions
    assert cfg.resolutions == jhash.HashGridConfig(**SMALL_GRID).resolutions


def test_replica_grid_is_hashed_above_res_79():
    """room_0's field (16 levels x 2^19 over an 8 m bound at voxel 0.06):
    the port derives the same grid, dense up to resolution 79."""
    config = load_config("configs/replica/room_0.yaml")
    tcfg = tdecoder.FeatureFieldConfig.from_config(config).grid_config
    jcfg = jdecoder.FeatureFieldConfig.from_config(config).grid_config
    assert tcfg.resolutions == jcfg.resolutions
    assert tcfg.table_size == 2 ** 19 and tcfg.n_levels == 16
    hashed = [r for r in tcfg.resolutions if (r + 1) ** 3 > tcfg.table_size]
    assert hashed == [r for r in tcfg.resolutions if r >= 80]
    assert len(hashed) == 4


@pytest.mark.parametrize("res", [5, 79, 133, 4096])
def test_corner_index_bit_identical(res):
    """The uint32 multiply-xor hash with wraparound, emulated in int64:
    the same table index for corners up to 2^20 (products past 2^32)."""
    rng = np.random.default_rng(res)
    hi = max(res, 1 << 20) if res == 4096 else res
    c = rng.integers(0, hi + 1, (3, 500)).astype(np.int32)
    T = 1 << 19
    j = np.asarray(jhash._corner_index(*(jnp.asarray(x) for x in c), res, T))
    t = thash._corner_index(*(torch.from_numpy(x.astype(np.int64))
                              for x in c), res, T).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("grid", ["small", "replica"])
def test_encode_matches_jax(grid):
    """encode on dense and hashed levels within 1e-6 (the table is
    uniform in +-1; features are sums of 8 weighted entries)."""
    if grid == "small":
        kw = SMALL_GRID
    else:
        kw = dict(desired_resolution=133)     # room_0's 16 x 2^19 grid
    jcfg, tcfg = _grid_pair(kw)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (tcfg.n_levels, tcfg.table_size,
                                tcfg.n_features)).astype(np.float32)
    pos = rng.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    j = np.asarray(jhash.encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    t = thash.encode(torch.from_numpy(table), torch.from_numpy(pos),
                     tcfg).numpy()
    assert t.shape == j.shape == (300, tcfg.out_dim)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def _field_cfgs(num_layers=3, hidden=32, final=64):
    kw = dict(bound=((-1.0, 3.0), (-2.0, 1.0), (0.5, 2.5)), voxel_sdf=0.1,
              num_layers=num_layers, hidden_dim=hidden, final_dim=final)
    return (jdecoder.FeatureFieldConfig(**kw),
            tdecoder.FeatureFieldConfig(**kw))


def _pos(n, seed=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1, 3, n), rng.uniform(-2, 1, n),
                     rng.uniform(0.5, 2.5, n)], -1).astype(np.float32)


@pytest.mark.parametrize("layers", [(2, 16, 32), (4, 128, 256)])
def test_decode_matches_jax_bf16_mlp(layers):
    """decode (bf16 operands, float32 accumulation) within 1e-5 of the JAX
    package's, with the JAX params carried across."""
    jcfg, tcfg = _field_cfgs(*layers)
    jp = jdecoder.init_decoder(jcfg, jax.random.PRNGKey(3))
    # a table of the trained scale: tcnn's 1e-4 init would leave the MLP
    # input near zero
    table = np.random.default_rng(4).uniform(
        -0.5, 0.5, np.asarray(jp["table"]).shape).astype(np.float32)
    jp = {"table": jnp.asarray(table), "layers": jp["layers"]}
    tp = convert.decoder_from_numpy(
        {"table": table, "layers": [np.asarray(w) for w in jp["layers"]]},
        device="cpu")
    pos = _pos(200)
    j = np.asarray(jdecoder.decode(jp, jnp.asarray(pos), jcfg))
    t = tdecoder.decode(tp, torch.from_numpy(pos), tcfg).numpy()
    assert t.shape == (200, tcfg.final_dim)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_decode_rounds_operands_to_bf16():
    """The MLP sees bf16 operands: a float32 product differs."""
    _, tcfg = _field_cfgs()
    tp = tdecoder.init_decoder(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tp["table"] = torch.rand(tp["table"].shape,
                             generator=torch.Generator().manual_seed(1))
    pos = torch.from_numpy(_pos(50))
    got = tdecoder.decode(tp, pos, tcfg)
    x = thash.encode(tp["table"], (pos - torch.tensor([-1.0, -2.0, 0.5]))
                     / torch.tensor([4.0, 3.0, 2.0]), tcfg.grid_config)
    for i, w in enumerate(tp["layers"]):
        x = x @ w
        if i < len(tp["layers"]) - 1:
            x = torch.relu(x)
    f32 = x / x.norm(dim=-1, keepdim=True)
    assert float((got - f32).abs().max()) > 1e-4


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A decoder the JAX package saved loads into the port bit for bit, and
    the port's save_params writes the JAX layout back."""
    jcfg, tcfg = _field_cfgs()
    jp = jdecoder.init_decoder(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path / "train_feat" / "ckpt.npz")
    jtrain.save_params(jp, path)
    tp = ttrain.load_params(path, device="cpu")
    np.testing.assert_array_equal(tp["table"].numpy(),
                                  np.asarray(jp["table"]))
    assert len(tp["layers"]) == len(jp["layers"]) == 3
    for a, b in zip(tp["layers"], jp["layers"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = str(tmp_path / "port.npz")
    ttrain.save_params(tp, back)
    jb = jtrain.load_params(back)
    for a, b in zip(jb["layers"], jp["layers"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pos = _pos(64, seed=6)
    np.testing.assert_allclose(
        tdecoder.decode(tp, torch.from_numpy(pos), tcfg).numpy(),
        np.asarray(jdecoder.decode(jp, jnp.asarray(pos), jcfg)), atol=1e-5)


def test_init_decoder_shapes_and_ranges():
    _, tcfg = _field_cfgs(4, 128, 256)
    p = tdecoder.init_decoder(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    g = tcfg.grid_config
    assert p["table"].shape == (g.n_levels, g.table_size, g.n_features)
    assert float(p["table"].abs().max()) <= 1e-4
    dims = [g.out_dim, 128, 128, 128, 256]
    for i, w in enumerate(p["layers"]):
        assert w.shape == (dims[i], dims[i + 1])
        assert float(w.abs().max()) <= 1 / np.sqrt(dims[i])
    q = tdecoder.init_decoder(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    assert torch.equal(p["layers"][2], q["layers"][2])


def test_cosine_loss_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = rng.normal(size=(40, 16)).astype(np.float32)
    b[3] = 0.0                                    # a zero row: eps clamp
    j = float(jdecoder.cosine_loss(jnp.asarray(a), jnp.asarray(b)))
    t = float(tdecoder.cosine_loss(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)

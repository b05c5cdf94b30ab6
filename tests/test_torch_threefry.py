"""The port of ``jax.random``'s threefry generator against the installed JAX.

Keys, splits, raw 32-bit bits and float32 uniforms, and the weights of
``init_gnn`` (GCN and 4-head GAT, at a small width and at the training
width: 3 layers, hidden 256) must equal the JAX package's bit for bit:
the floats are compared as int32 views, so the sign of a zero counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro_torch.core import threefry
from repro_torch.models.gnn import GNNConfig, init_gnn

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(64, 256), (256, 16), (4, 64, 1), (7, 13)]  # 7 * 13: an odd count


def _bits_equal(got, want):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.float32:
        got, want = got.astype(np.float32).view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    _bits_equal(threefry.prng_key(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 6])
def test_split_matches_jax(seed, num):
    key = threefry.prng_key(seed)
    _bits_equal(threefry.split(key, num), jax.random.split(jax.random.PRNGKey(seed), num))
    # a split key splits again as JAX's does
    _bits_equal(threefry.split(threefry.split(key, num)[num - 1], 3),
                jax.random.split(jax.random.split(jax.random.PRNGKey(seed), num)[num - 1], 3))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_match_jax(seed, shape):
    _bits_equal(threefry.random_bits(threefry.prng_key(seed), shape),
                jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax(seed, shape):
    key, jkey = threefry.prng_key(seed), jax.random.PRNGKey(seed)
    for lo, hi in [(0.0, 1.0), (-0.13693063937629152, 0.13693063937629152), (-1.2247, 1.2247),
                   (-3.0, 0.5)]:
        _bits_equal(threefry.uniform(key, shape, lo, hi),
                    jax.random.uniform(jkey, shape, jnp.float32, lo, hi))


@pytest.mark.parametrize("seed", [-1, 2**31, 1.5, True, "0"])
def test_prng_key_rejects_a_seed_outside_int32(seed):
    with pytest.raises(ValueError, match="seed"):
        threefry.prng_key(seed)


GNNS = {
    "gcn-small": dict(model="gcn", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4),
    "gat-small": dict(model="gat", num_layers=2, in_dim=16, hidden_dim=32, num_classes=4,
                      num_heads=4),
    "gcn-train": dict(model="gcn", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16),
    "gat-train": dict(model="gat", num_layers=3, in_dim=64, hidden_dim=256, num_classes=16,
                      num_heads=4),
}


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("name", list(GNNS))
def test_init_gnn_matches_jax(name, seed):
    cfg = GNNS[name]
    want = j_init_gnn(jax.random.PRNGKey(seed), JGNNConfig(**cfg))["layers"]
    got = init_gnn(GNNConfig(**cfg), seed=seed, device="cpu").layers
    assert len(got) == len(want) == cfg["num_layers"]
    for layer, jl in zip(got, want):
        params = dict(layer.named_parameters())
        assert set(params) == set(jl)
        for k in jl:
            _bits_equal(params[k].detach(), jl[k])

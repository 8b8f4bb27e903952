"""murmur3 mixing and the counter-based draws: the port's int64-carried u32
arithmetic equals the JAX package's wrapping uint32 arithmetic bit for bit
(tolerance 0), on vectors that include 0 and 2^32 - 1, across all 16
purposes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu.ops import hashing as jh
from dispersy_tpu.ops import rng as jr

from dispersy_tpu_torch.ops import hashing as ph
from dispersy_tpu_torch.ops import rng as pr
from dispersy_tpu_torch.u32 import narrow

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

from test_torch_ops import release_xla_executables  # noqa: E402,F401

PURPOSES = [getattr(jr, n) for n in dir(jr) if n.startswith("P_")]


def values(seed: int, size: int = 257) -> np.ndarray:
    rs = np.random.default_rng(seed)
    v = rs.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32)
    v[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return v


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = narrow(got).view(torch.int32).numpy().view(np.uint32) \
        if got.dtype != torch.float32 else got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_purposes_are_the_sixteen():
    assert sorted(PURPOSES) == list(range(1, 17))
    assert all(getattr(pr, n) == getattr(jr, n)
               for n in dir(jr) if n.startswith("P_"))


@pytest.mark.parametrize("seed", [0, 1])
def test_fmix32_hash_combine(seed):
    x, y = values(seed), values(seed + 10)
    same(ph.fmix32(t(x)), jh.fmix32(jnp.asarray(x)))
    for s in (jh.BLOOM_SEED_1, jh.BLOOM_SEED_2, jh.BLOOM_SALT_SEED, 0):
        same(ph.hash_u32(t(x), s), jh.hash_u32(jnp.asarray(x), s))
    same(ph.combine(t(x), t(y)), jh.combine(jnp.asarray(x), jnp.asarray(y)))


def test_record_hash():
    m, g, p = values(2), values(3), values(4)
    meta = (values(5) & 0xFF).astype(np.uint8)
    same(ph.record_hash(t(m), t(g), torch.from_numpy(meta), t(p)),
         jh.record_hash(jnp.asarray(m), jnp.asarray(g), jnp.asarray(meta),
                        jnp.asarray(p)))


@pytest.mark.parametrize("purpose", PURPOSES)
def test_draws_every_purpose(purpose):
    key = np.array([0x12345678, 0xFFFFFFFF], np.uint32)
    seed_p = pr.fold_seed(t(key))
    seed_j = jr.fold_seed(jnp.asarray(key))
    same(seed_p, seed_j)
    peers = np.arange(-1, 64, dtype=np.int32)
    salt = values(purpose, peers.size)
    for rnd in (0, 5, 0xFFFFFFFF):
        want_u = jr.rand_u32(seed_j, jnp.uint32(rnd), jnp.asarray(peers),
                             purpose, jnp.asarray(salt))
        got_u = pr.rand_u32(seed_p, torch.tensor(rnd),
                            torch.from_numpy(peers), purpose, t(salt))
        same(got_u, want_u)
        same(pr.rand_uniform(seed_p, torch.tensor(rnd),
                             torch.from_numpy(peers), purpose),
             jr.rand_uniform(seed_j, jnp.uint32(rnd), jnp.asarray(peers),
                             purpose))

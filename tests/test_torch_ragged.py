"""K12 ``deliver_ragged`` and K1 ``deliver`` with admission classes: the
port's plain versions (what a CPU tensor takes) against the JAX package's
ops on the same numpy inputs, bit for bit (tolerance 0: both are integer
sorts and scatters).  Every shard count of the chaos round's planes, an
edge count that the shards do not divide, the class operand on and off,
an exact and a binding bucket budget, receipts on and off; K12's capped
corners (``profiling.ragged_corner``: a hot crossing destination, the
boundary at a row's first and last edge, budgets binding in some
buckets only); at budget 0 the ragged exchange also equals the global
delivery."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu.ops import inbox as jinbox

from dispersy_tpu_torch import kernels, profiling
from dispersy_tpu_torch.exceptions import KernelError
from dispersy_tpu_torch.ops import inbox

from test_torch_ops import (release_xla_executables,  # noqa: F401
                            same, to_np, to_t, u32)


def edges(rs, e, n, w=0, hot=0.2):
    """A random edge list over ``n`` destinations: parked ends, a hot
    destination (a group far above 32), u32 / u8 / bool columns and an
    optional [E, w] column, u8 classes."""
    dst = rs.integers(-1, n + 1, size=e).astype(np.int32)
    dst[rs.random(e) < hot] = 3
    valid = rs.random(e) < 0.8
    cols = [np.arange(e, dtype=np.uint32), u32(rs, e),
            rs.integers(0, 256, size=e).astype(np.uint8), rs.random(e) < 0.5]
    if w:
        cols.append(u32(rs, e, w))
    cls = rs.integers(0, 256, size=e).astype(np.uint8)
    return dst, valid, cols, cls


# One compiled program per static shape (the ops dispatched one by one
# would compile each primitive on its own).
_JAX_RAGGED = jax.jit(jinbox.deliver_ragged,
                      static_argnames=("n_peers", "inbox_size", "shards",
                                       "budget", "need_receipts"))
_JAX_DELIVER = jax.jit(jinbox.deliver,
                       static_argnames=("n_peers", "inbox_size"))


def jax_ragged(dst, valid, cols, cls, n, q, s, budget, receipts):
    return _JAX_RAGGED(
        jnp.asarray(dst), [jnp.asarray(c) for c in cols], jnp.asarray(valid),
        n_peers=n, inbox_size=q, shards=s, budget=budget,
        cls=None if cls is None else jnp.asarray(cls.astype(np.uint32)),
        need_receipts=receipts)


def port_ragged(dst, valid, cols, cls, n, q, s, budget, receipts):
    return inbox.deliver_ragged(
        to_t(dst), [to_t(c) for c in cols], to_t(valid), n, q, s, budget,
        None if cls is None else to_t(cls), receipts)


# (budget, class operand, receipts): each knob both ways, binding budgets
# of one and of a few edges.
RAGGED_CASES = [(1, True, True), (3, False, False), (0, True, False),
                (0, False, True)]


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("budget,with_cls,receipts", RAGGED_CASES)
def test_deliver_ragged_equals_jax(s, budget, with_cls, receipts):
    rs = np.random.default_rng(100 * s + 10 * budget + 2 * with_cls
                               + receipts)
    n, q, e = 64, 3, 4 * 64 + 5          # E % S != 0: the padded rows
    assert e % s
    dst, valid, cols, cls = edges(rs, e, n, w=2)
    cls = cls if with_cls else None
    want = jax_ragged(dst, valid, cols, cls, n, q, s, budget, receipts)
    got = port_ragged(dst, valid, cols, cls, n, q, s, budget, receipts)
    same(got.delivery.inbox, want.delivery.inbox)
    same(got.delivery[1:], want.delivery[1:])
    same([got.shed], [want.shed])
    shed = int(to_np(got.shed).sum())
    # A binding budget sheds; the exact exchange never does.
    assert (shed > 0) == (budget > 0)
    if not receipts:
        assert (to_np(got.delivery.edge_slot) == -1).all()
    # An edge is never counted both as shed and as landed or dropped.
    landed = to_np(got.delivery.inbox_valid).sum()
    dropped = to_np(got.delivery.n_dropped).sum()
    ok = valid & (dst >= 0) & (dst < n)
    assert landed + dropped + shed == ok.sum()


# (corner of ``profiling.ragged_corner``, S, classes): a hot crossing
# destination (its groups cross deep inside, with classes and without),
# the boundary at a row's first edge and at the padded last row's last
# edge, and budgets that bind in some buckets only; E % S != 0 in each.
CORNER_CASES = [
    pytest.param("hot_crossing", 4, True, id="hot_crossing-s4"),
    pytest.param("hot_crossing", 2, False, id="hot_crossing-s2-nocls"),
    pytest.param("first_edge", 4, True, id="first_edge-s4"),
    pytest.param("last_edge", 8, True, id="last_edge-s8"),
    pytest.param("some_buckets", 2, True, id="some_buckets-s2"),
    pytest.param("budget_el_minus_1", 4, False, id="budget_el_minus_1-s4"),
]


@pytest.mark.parametrize("corner,s,with_cls", CORNER_CASES)
def test_deliver_ragged_corners_equal_jax(corner, s, with_cls):
    """K12's capped corners: the port's plain version against the JAX op,
    and the bucket boundaries the corner means to build
    (``profiling.ragged_bounds``)."""
    rs = np.random.default_rng(sum(map(ord, corner)) + s)
    n, q, e = 64, 3, 4 * 64 + 5
    assert e % s
    dst, valid, cls, budget = profiling.ragged_corner(rs, corner, n, e, s)
    cols = [np.arange(e, dtype=np.uint32), u32(rs, e)]
    cls = cls if with_cls else None
    el = -(-e // s)
    assert 1 <= budget < el
    want = jax_ragged(dst, valid, cols, cls, n, q, s, budget, True)
    got = port_ragged(dst, valid, cols, cls, n, q, s, budget, True)
    same(got.delivery.inbox, want.delivery.inbox)
    same(got.delivery[1:], want.delivery[1:])
    same([got.shed], [want.shed])
    rb = profiling.ragged_bounds(to_t(dst), to_t(valid),
                                 None if cls is None else to_t(cls), n, s,
                                 budget)
    binding = rb["binding"].nonzero().flatten().tolist()
    h0 = s // 2
    if corner == "hot_crossing":
        hot = binding.index(h0)
        assert rb["m1"][hot] > 0 and rb["group"][hot] > rb["m1"][hot]
    if corner == "first_edge":
        assert rb["l"][binding.index(h0)] == 0
    if corner == "last_edge":
        at = binding.index((s - 1) * s + h0)
        assert rb["m2"][at] == 3 and rb["l"][at] == e - 1 - (s - 1) * el
    if corner in ("some_buckets", "budget_el_minus_1"):
        assert 0 < len(binding) < s * s
    # The shed edges are those past each bucket's boundary.
    assert int(to_np(got.shed).sum()) == int(
        (rb["count"] - rb["b"]).clamp(min=0).sum())


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("with_cls", [False, True])
def test_ragged_at_budget_zero_is_the_global_delivery(s, with_cls):
    rs = np.random.default_rng(7 + s)
    n, q, e = 40, 4, 203
    dst, valid, cols, cls = edges(rs, e, n)
    cls = cls if with_cls else None
    want = _JAX_DELIVER(
        jnp.asarray(dst), [jnp.asarray(c) for c in cols], jnp.asarray(valid),
        n_peers=n, inbox_size=q,
        cls=None if cls is None else jnp.asarray(cls.astype(np.uint32)))
    got = port_ragged(dst, valid, cols, cls, n, q, s, 0, True)
    same(got.delivery.inbox, want.inbox)
    same(got.delivery[1:], want[1:])
    assert not to_np(got.shed).any()


# (E, N, Q, classes): random classes, then the radix core's corners --
# every class equal (the order is plain edge order) and one group of 256
# edges holding all 256 classes once.
CLS_CASES = [
    pytest.param(200, 16, 3, "random", id="200-16-3"),
    pytest.param(1000, 3, 64, "random", id="1000-3-64"),
    pytest.param((1 << 18) + 5, 64, 4, "random", id="262149-64-4"),
    pytest.param(300, 7, 4, "equal", id="300-7-4-equal"),
    pytest.param(600, 40, 260, "distinct", id="600-40-260-distinct"),
]


@pytest.mark.parametrize("e,n,q,classes", CLS_CASES)
def test_deliver_with_cls_equals_jax(e, n, q, classes):
    """K1's (destination, class, position) order, in the packed-key form
    of the JAX op and, where destination, class and position bits pass
    32 (the third shape), its three-key form."""
    rs = np.random.default_rng(e + q)
    dst, valid, cols, cls = edges(rs, e, n, hot=0.0)
    if classes == "equal":
        cls[:] = 7
    if classes == "distinct":
        dst[:256] = 5
        valid[:256] = True
        cls[:256] = rs.permutation(256)
        dst[256:][dst[256:] == 5] = 6
    want = _JAX_DELIVER(
        jnp.asarray(dst), [jnp.asarray(c) for c in cols[:2]],
        jnp.asarray(valid), n_peers=n, inbox_size=q,
        cls=jnp.asarray(cls.astype(np.uint32)))
    got = inbox.deliver(to_t(dst), [to_t(c) for c in cols[:2]],
                        to_t(valid), n, q, to_t(cls))
    same(got.inbox, want.inbox)
    same(got[1:], want[1:])
    # The class orders the edges: the same edges in plain edge order land
    # differently, unless every class is the same.
    plain = inbox.deliver(to_t(dst), [to_t(cols[0])], to_t(valid), n, q)
    assert torch.equal(plain.inbox[0], got.inbox[0]) == (classes == "equal")
    if classes == "distinct":
        landed = to_np(got.inbox[1])[5][:256]
        assert (to_np(got.inbox_valid)[5][:256]).all()
        np.testing.assert_array_equal(np.sort(cls[:256]), np.arange(256))
        # Slot s holds the edge of class s.
        order = np.argsort(cls[:256])
        np.testing.assert_array_equal(landed, cols[1][:256][order])


def test_wrappers_refuse_cpu_tensors():
    """On a tensor that is not on the card a kernel wrapper raises; the
    ops take the plain version for a CPU tensor before reaching it."""
    dst = torch.zeros(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    cols = [torch.zeros(8, dtype=torch.int32).view(torch.uint32)]
    with pytest.raises(KernelError, match="CUDA"):
        kernels.deliver_ragged(dst, cols, valid, 8, 2, 2, 1)
    with pytest.raises(KernelError, match="CUDA"):
        kernels.deliver(dst, cols, valid, 8, 2,
                        torch.zeros(8, dtype=torch.uint8))

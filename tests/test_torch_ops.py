"""Each op of the port (on the CPU: the plain version beside each kernel's
wrapper) against the JAX package's op on the same numpy inputs, bit for
bit (tolerance 0: every op here is integer or elementwise float32 work).

The kernel ops (K1 deliver, K2 bloom, K3 store_insert, K4
rank_compact_many, K5 intake checks, K6 digest_update, K7 store_stage)
run at their ``@contract`` dims (``dispersy_tpu/ops/contracts.py``) and at
random small shapes; where the JAX op has more than one form, every form
is held against the port.  The byte-diet store's call shapes (u16 aux
columns, per-row Bloom salts, the store-less dedup, cohort blocks) have
cases of their own at the end.
"""

import gc
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu.ops import bloom as jbloom
from dispersy_tpu.ops import candidates as jcand
from dispersy_tpu.ops import inbox as jinbox
from dispersy_tpu.ops import intake as jintake
from dispersy_tpu.ops import rng as jrng
from dispersy_tpu.ops import store as jstore
from dispersy_tpu.ops.contracts import DIMS
from dispersy_tpu.config import CommunityConfig as JaxConfig

from dispersy_tpu_torch import profiling
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.ops import bloom, inbox, intake, rng
from dispersy_tpu_torch.ops import candidates as cand
from dispersy_tpu_torch.ops import store as st

# One torch thread: the cases are small, and under pytest-xdist each
# worker's OpenMP pool (a thread a core by default) would take the cores
# the other workers' XLA compiles need.
torch.set_num_threads(1)

U32_MAX = 0xFFFFFFFF


def _count_lines(path: str) -> int:
    try:
        with open(path) as f:
            return sum(1 for _ in f)
    except OSError:             # no procfs: nothing to count
        return 0


def _map_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 0


def _drop_executables():
    """Drop the compiled executables JAX keeps in its caches (the eager
    primitives', the jitted functions' fast paths, the lowered programs')
    and keep the traced jaxprs.  After ``test_engine.py``,
    ``test_inbox.py`` and ``test_store.py`` in one process this frees
    the same mappings as ``jax.clear_caches`` (15,022 -> 786) in about
    half its time: the rest of that call goes to freeing the jaxpr
    caches, which every later test would then trace again."""
    from jax._src import dispatch, pjit
    from jax._src.interpreters import pxla
    from jax._src.lib import xla_client
    dispatch.xla_primitive_callable.cache_clear()
    pjit._pjit_lower.cache_clear()
    pxla._cached_compilation.cache_clear()
    pjit._cpp_pjit_cache_fun_only.clear()
    pjit._cpp_pjit_cache_explicit_attributes.clear()
    xla_client._xla.PjitFunctionCache.clear_all()


@pytest.fixture(autouse=True)
def release_xla_executables():
    """Free the process's compiled XLA executables before a port test
    once it holds more than half the kernel's memory-map limit.  Every
    executable XLA:CPU loads keeps its own mappings until its cache entry
    goes, and a pytest-xdist worker that has run a few hundred of the
    suite's tests holds over 60,000 of Linux's default 65,530: the next
    compile then fails to map and the worker dies with a segfault.  The
    port's files run late in a worker's life, so they give the room back
    (any test after them recompiles what it needs): the executables
    first, every cache of JAX only if that left the process above half
    the limit (or this JAX keeps its caches elsewhere).  Imported by
    every port test file."""
    limit = _map_limit()
    if limit and _count_lines("/proc/self/maps") > limit // 2:
        try:
            _drop_executables()
        except (ImportError, AttributeError) as e:
            # This JAX keeps its caches elsewhere: every drop is now the
            # whole jax.clear_caches(), the slow clear that costs the
            # suite minutes.  Say so: pytest lists it in its summary.
            warnings.warn(f"release_xla_executables: JAX's executable "
                          f"caches not found ({e!r}); falling back to "
                          f"jax.clear_caches()", RuntimeWarning)
        gc.collect()
        if _count_lines("/proc/self/maps") > limit // 2:
            jax.clear_caches()
            gc.collect()
    yield


# ---- numpy <-> both packages ----------------------------------------------

def to_t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, u32/u16 through their signed views."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        if x.dtype == torch.uint16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def same(got, want) -> None:
    for g, w in zip(got, want, strict=True):
        g, w = to_np(g), to_np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype,
                                                          g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def ref(fn, *args, **kw):
    """``fn(*args, **kw)`` of the JAX package compiled as one program:
    the array leaves of the arguments are traced, every other leaf (a
    width, a mode, a config) is bound as it is.  One XLA compile per call
    instead of one per primitive of the eager form; the closure is new on
    every call, so each call traces ``fn`` afresh (a monkeypatched form
    included) and reuses no earlier compile."""
    leaves, tree = jax.tree.flatten((args, kw))
    traced = [isinstance(x, (jax.Array, np.ndarray)) for x in leaves]

    def run(*arrays):
        it = iter(arrays)
        a, k = jax.tree.unflatten(tree, [next(it) if t else x
                                         for x, t in zip(leaves, traced)])
        return fn(*a, **k)
    return jax.jit(run)(*(x for x, t in zip(leaves, traced) if t))


def u32(rs, *shape, hi=1 << 32):
    return rs.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


# ---- K1 deliver -------------------------------------------------------------

DELIVER_SHAPES = [  # (E, N, Q, W, p_valid, exact groups)
    (DIMS["E"], DIMS["N"], DIMS["Q"], DIMS["W"], 0.8, ()),  # contract dims
    (200, 16, 3, 0, 0.9, ()),     # overflow everywhere
    (333, 40, 5, 15, 0.5, ()),    # the [E, 15] bloom column
    (1000, 3, 64, 0, 0.7, ()),    # tracker-like: few large groups
    # The radix core's corners: groups of exactly 32 and 33 edges, one
    # hot destination above 2048 edges, no edges, every edge invalid,
    # Q = 1, and n not a multiple of 1024.
    (100, 6, 32, 0, 1.0, (32, 33)),
    (2400, 5, 40, 3, 1.0, (2100,)),
    (0, 8, 4, 0, 0.5, ()),
    (50, 16, 4, 0, 0.0, ()),
    (300, 20, 1, 2, 0.9, ()),
    (4000, 1027, 3, 0, 0.8, ()),
]


def _shape_id(shape) -> str:
    """The parameter id: the first five fields as pytest writes them, then
    the exact groups, if any."""
    head = "-".join(str(v) for v in shape[:5])
    return head + "".join(f"-g{g}" for g in shape[5])


def deliver_dst(rs, e, n, groups):
    """Destinations in [-2, n + 2) (parked ends), with destination i
    holding exactly ``groups[i]`` edges at random positions."""
    k = len(groups)
    dst = np.concatenate([np.full(g, i) for i, g in enumerate(groups)]
                         + [rs.integers(k, n + 2, size=e - sum(groups))])
    if not k:
        dst = rs.integers(-2, n + 2, size=e)
    return rs.permutation(dst).astype(np.int32)


@pytest.mark.parametrize("e,n,q,w,p,groups", DELIVER_SHAPES,
                         ids=[_shape_id(s) for s in DELIVER_SHAPES])
def test_deliver(e, n, q, w, p, groups):
    rs = np.random.default_rng(e + n)
    dst = deliver_dst(rs, e, n, groups)
    valid = rs.random(e) < p
    cols = [np.arange(e, dtype=np.uint32), u32(rs, e),
            rs.integers(0, 256, size=e).astype(np.uint8),
            rs.random(e) < 0.5]
    if w:
        cols.append(u32(rs, e, w))
    want = ref(jinbox.deliver, dst, cols, valid, n, q)
    got = inbox.deliver(to_t(dst), [to_t(c) for c in cols], to_t(valid), n,
                        q)
    same(got.inbox, want.inbox)
    same(got[1:], want[1:])
    assert int(to_np(got.n_dropped).sum()) > 0 or e < n * q
    for i, g in enumerate(groups):
        assert int(to_np(got.n_dropped)[i]) == max(0, g - q)
        assert int(to_np(got.inbox_valid)[i].sum()) == min(g, q)


# ---- K2 bloom -----------------------------------------------------------------

BLOOM_SHAPES = [  # (N, M, W, H)
    (DIMS["N"], DIMS["M"], DIMS["W"], DIMS["H"]),
    (64, 48, 15, 7),           # the 1M slice's row shape
    (9, 31, 3, 1),
]


@pytest.mark.parametrize("n,m,w,k", BLOOM_SHAPES)
@pytest.mark.parametrize("salted", [False, True])
def test_bloom_build_query_probes(n, m, w, k, salted):
    rs = np.random.default_rng(n * m + k)
    h = u32(rs, n, m)
    mask = rs.random((n, m)) < 0.6
    bits = 32 * w
    salt_np = np.uint32(0xDEADBEEF)
    js = jnp.uint32(salt_np) if salted else None
    ps = to_t(np.array(salt_np)) if salted else None
    same([bloom.probe_bits(to_t(h), bits, k, ps).to(torch.int32)],
         [ref(jbloom.probe_bits, h, bits, k, js)])
    words = bloom.bloom_build(to_t(h), to_t(mask), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([words], [ref(jbloom.bloom_build, h, mask, bits, k, impl=impl,
                           salt=js)])
    q = np.where(rs.random((n, m)) < 0.5, h, u32(rs, n, m))
    got = bloom.bloom_query(words, to_t(q), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([got], [ref(jbloom.bloom_query, to_np(words), q, bits, k,
                         impl=impl, salt=js)])
    dense = rs.random((n, bits)) < 0.3
    same([bloom.pack_bits(to_t(dense))],
         [ref(jbloom.pack_bits, dense).reshape(n, w)])
    same([bloom.unpack_bits(bloom.pack_bits(to_t(dense)))], [dense])


def _bloom_bits_in_use() -> list:
    """Every Bloom size of the configs the port runs and of the test
    shapes, with the corners ``chip_smoke.py`` holds the kernels at."""
    from dispersy_tpu_torch import kernels, profiling
    cfgs = (CommunityConfig(), profiling.slice_config(4096),
            profiling.bench_config(4096), profiling.permissioned_config(4096),
            profiling.hardened_config(4096), profiling.chaos_config(4096, 0),
            profiling.chaos_config(4096))
    return sorted({c.bloom_bits for c in cfgs}
                  | {32 * w for _, _, w, _ in BLOOM_SHAPES}
                  | {96, 480, 2464, 32 * kernels.BLOOM_MAX_WORDS})


def reciprocal_mod(x: np.ndarray, n_bits: int) -> np.ndarray:
    """csrc/bloom.cu's ``mod_of``, step for step, on u32 numerators."""
    from dispersy_tpu_torch import kernels
    magic, shift = kernels.bloom_reciprocal(n_bits)
    x = x.astype(np.uint64)
    t = (x * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((x - t) >> np.uint64(1))) >> np.uint64(shift)
    return (x - q * np.uint64(n_bits)).astype(np.uint32)


@pytest.mark.parametrize("n_bits", _bloom_bits_in_use())
def test_bloom_reciprocal_remainder(n_bits):
    """csrc/bloom.cu takes a probe's ``x % n_bits`` as a multiply-high by
    the host's reciprocal (``kernels.bloom_reciprocal``): exact for every
    u32 numerator, since the probe chain ``h1 + j * h2`` wraps mod 2^32
    -- on the boundaries (0, d - 1, d, the multiples of d and their
    neighbours, 2^31, 2^32 - 1) and on 2^20 numpy-seeded values."""
    d, top = n_bits, (1 << 32) - 1
    qs = np.unique(np.linspace(0, top // d, 4097).astype(np.uint64))
    x = np.concatenate([
        np.array([0, 1, d - 1, d, d + 1, (1 << 31) - 1, 1 << 31,
                  (1 << 31) + 1, top - 1, top], np.uint64),
        *(np.clip(qs.astype(np.int64) * d + off, 0, top).astype(np.uint64)
          for off in (-1, 0, 1)),
        np.random.default_rng(n_bits).integers(0, 1 << 32, size=1 << 20,
                                               dtype=np.uint64)])
    got = reciprocal_mod(x, d)
    assert np.array_equal(got, (x % np.uint64(d)).astype(np.uint32))


# ---- K3 store_insert and the store helpers ---------------------------------

def ring(rs, n, m, keys=200, members=6):
    """Sorted rings with random fill and small key ranges (duplicates)."""
    g = rs.integers(1, keys, size=(n, m))
    mem = rs.integers(0, members, size=(n, m))
    order = np.lexsort((mem, g), axis=1)
    live = np.arange(m)[None, :] < rs.integers(0, m + 1, size=n)[:, None]
    cols = [np.where(live, np.take_along_axis(g, order, 1), U32_MAX),
            np.where(live, np.take_along_axis(mem, order, 1), U32_MAX),
            np.where(live, rs.integers(0, 4, size=(n, m)), 255),
            np.where(live, u32(rs, n, m), U32_MAX),
            np.where(live, rs.integers(0, 3, size=(n, m)), 0),
            np.where(live, rs.integers(0, 2, size=(n, m)), 0)]
    dts = (np.uint32, np.uint32, np.uint8, np.uint32, np.uint32, np.uint8)
    return [c.astype(dt) for c, dt in zip(cols, dts)]


def batch(rs, n, b, keys=200, members=6):
    return [u32(rs, n, b, hi=keys), u32(rs, n, b, hi=members),
            rs.integers(0, 4, size=(n, b)).astype(np.uint8), u32(rs, n, b),
            u32(rs, n, b, hi=3), rs.integers(0, 2, size=(n, b)).astype(
                np.uint8)]


STORE_SHAPES = [  # (N, M, B, key range)
    (DIMS["N"], DIMS["M"], DIMS["B"], 20),
    (32, 48, 24, 200),         # the slice's ring and intake widths
    (16, 8, 20, 12),           # capacity overflow: batch wider than ring
    (8, 12, 1, 5),             # create_messages' one-record batch
    (6, 200, 56, 40),          # M + B = 256, K3's widest row
]


@pytest.mark.parametrize("n,m,b,keys", STORE_SHAPES)
@pytest.mark.parametrize("merge", [False, True])
def test_store_insert(n, m, b, keys, merge, monkeypatch):
    monkeypatch.setattr(jstore, "_prefer_merge", lambda width: merge)
    rs = np.random.default_rng(n * m * b + keys)
    s, bt = ring(rs, n, m, keys), batch(rs, n, b, keys)
    # Duplicates against the ring: copy some ring keys into the batch.
    take = rs.random((n, b)) < 0.3
    src = rs.integers(0, m, size=(n, b))
    for c in (0, 1):
        bt[c] = np.where(take & (s[0][np.arange(n)[:, None], src] != U32_MAX),
                         s[c][np.arange(n)[:, None], src], bt[c])
    mask = rs.random((n, b)) < 0.7
    want = ref(jstore.store_insert, jstore.StoreCols(*s),
               jstore.StoreCols(*bt), mask)
    got = st.store_insert(st.StoreCols(*map(to_t, s)),
                          st.StoreCols(*map(to_t, bt)), to_t(mask))
    same(got.store, want.store)
    same(got[1:], want[1:])
    assert int(to_np(got.n_dropped).sum()) > 0   # dups or overflow hit


@pytest.mark.parametrize("n,m,b,keys,holes", [
    (24, 48, 24, 30, False),   # the intake merge's widths, permuted rings
    (16, 12, 8, 6, True),      # EMPTY holes amid the live records
])
def test_store_insert_unsorted_ring(n, m, b, keys, holes, monkeypatch):
    """Rings that break the round invariant (records out of (gt, member)
    order, EMPTY slots amid live ones) against the JAX sort form, which
    has no precondition on the ring's order (the merge form presumes a
    sorted ring, so it is not held here)."""
    monkeypatch.setattr(jstore, "_prefer_merge", lambda width: False)
    rs = np.random.default_rng(n * m + b + keys)
    s, bt = ring(rs, n, m, keys), batch(rs, n, b, keys)
    order = np.argsort(rs.random((n, m)), axis=1)
    s = [np.take_along_axis(c, order, 1) for c in s]
    if holes:   # gt EMPTY over a record, its member left in place
        s[0] = np.where(rs.random((n, m)) < 0.3, U32_MAX, s[0]).astype(
            np.uint32)
    keys_s = (s[0].astype(np.uint64) << np.uint64(32)) | s[1]
    live = s[0] != U32_MAX
    assert (live[:, 1:] & (~live[:, :-1] | (keys_s[:, 1:] < keys_s[:, :-1]))
            ).any()
    mask = rs.random((n, b)) < 0.7
    want = ref(jstore.store_insert, jstore.StoreCols(*s),
               jstore.StoreCols(*bt), mask)
    got = st.store_insert(st.StoreCols(*map(to_t, s)),
                          st.StoreCols(*map(to_t, bt)), to_t(mask))
    same(got.store, want.store)
    same(got[1:], want[1:])


@pytest.mark.parametrize("n,m", [(DIMS["N"], DIMS["M"]), (40, 48)])
def test_store_slices_and_counts(n, m):
    rs = np.random.default_rng(n + m)
    g = ring(rs, n, m)[0]
    same([st.count_valid(to_t(g))], [jstore.count_valid(jnp.asarray(g))])
    for cap in (3, m, m + 5):
        ps = st.claim_slice_largest(to_t(g), cap)
        same([to_t(to_np(c).astype(np.uint32)) for c in ps],
             jstore.claim_slice_largest(jnp.asarray(g), cap))
        for rnd in (0, 7, U32_MAX):
            ps = st.claim_slice_modulo(to_t(g), cap, torch.tensor(rnd))
            js = jstore.claim_slice_modulo(jnp.asarray(g), cap,
                                           jnp.uint32(rnd))
            same([to_t(to_np(c).astype(np.uint32)) for c in ps], js)
            same([st.slice_mask(to_t(g), ps)],
                 [jstore.slice_mask(jnp.asarray(g), js)])
    lo, hi = u32(rs, n, hi=100), u32(rs, n, hi=300)
    hi[::3] = 0
    mod, off = u32(rs, n, hi=4) + 1, u32(rs, n, hi=3)
    same([st.slice_mask(to_t(g), st.SyncSlice(*map(to_t, (lo, hi, mod,
                                                          off))))],
         [jstore.slice_mask(jnp.asarray(g), jstore.SyncSlice(
             *map(jnp.asarray, (lo, hi, mod, off))))])


# ---- K4 rank compaction ------------------------------------------------------

@pytest.mark.parametrize("n,w,width", [(DIMS["N"], DIMS["M"], DIMS["B"]),
                                       (32, 48, 8), (16, 24, 4)])
@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_rank_compact_many(n, w, width, impl):
    rs = np.random.default_rng(n * w + width)
    live = rs.random((n, w)) < 0.4
    rank = np.cumsum(live, axis=1) - 1
    slot = np.where(live & (rank < width), rank, width).astype(np.int32)
    cols = [(u32(rs, n, w), U32_MAX), (u32(rs, n, w), 0),
            (rs.integers(0, 256, size=(n, w)).astype(np.uint8), 0xFF),
            (rs.integers(0, 256, size=(n, w)).astype(np.uint8), 0),
            (live, False)]
    want = ref(jstore.rank_compact_many, cols, slot, width, impl=impl)
    got = st.rank_compact_many([(to_t(c), f) for c, f in cols], to_t(slot),
                               width)
    same(got, want)
    same([st.rank_compact(to_t(cols[0][0]), to_t(slot), width, U32_MAX)],
         [ref(jstore.rank_compact, cols[0][0], slot, width, U32_MAX)])


# K4's corners (the gather kernel's branches; held here as the plain
# version against the JAX package), N = 203: ``profiling.compact_corners``.
# The negative slot is -1 only: the JAX package's flat scatter sends slot
# -1 to the previous row's spill column, so -1 is the negative slot both
# packages drop.
COMPACT_CORNERS = profiling.compact_corners(negative=(-1,))


@pytest.mark.parametrize("corner", sorted(COMPACT_CORNERS))
@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_rank_compact_many_corners(corner, impl):
    kw = dict(COMPACT_CORNERS[corner])
    w, width = kw.pop("w"), kw.pop("width")
    rs = np.random.default_rng(w * 1000 + width)
    slot, cols = profiling.compact_arrays(rs, 203, w, width, **kw)
    want = ref(jstore.rank_compact_many, cols, slot, width, impl=impl)
    got = st.rank_compact_many([(to_t(c), f) for c, f in cols], to_t(slot),
                               width)
    same(got, want)


# ---- K5 intake checks ----------------------------------------------------------

@pytest.mark.parametrize("n,m,b", [(DIMS["N"], DIMS["M"], DIMS["B"]),
                                   (32, 48, 24), (8, 5, 40)])
@pytest.mark.parametrize("impl", ["broadcast", "chunked"])
def test_intake_checks(n, m, b, impl):
    rs = np.random.default_rng(n + m + b)
    s = ring(rs, n, m, keys=30, members=3)
    bg, bm = u32(rs, n, b, hi=30), u32(rs, n, b, hi=3)
    ok = rs.random((n, b)) < 0.7
    want_in = ref(jintake.in_store, jstore.StoreCols(*s), bm, bg, impl=impl)
    want_dup = ref(jintake.dup_earlier, bm, bg, ok, impl=impl)
    pstc = st.StoreCols(*map(to_t, s))
    got = intake.intake_checks(pstc.gt, pstc.member, to_t(bm), to_t(bg),
                               to_t(ok))
    same(got, [want_in, want_dup])
    if n * b > 100:
        assert to_np(got[0]).any() and to_np(got[1]).any()


# K5's corners (the search kernel's branches), N = 203:
# ``profiling.INTAKE_CORNERS``.
INTAKE_CORNERS = profiling.INTAKE_CORNERS


@pytest.mark.parametrize("corner", sorted(INTAKE_CORNERS))
@pytest.mark.parametrize("impl", ["broadcast", "chunked"])
def test_intake_checks_corners(corner, impl):
    kw = dict(INTAKE_CORNERS[corner])
    m, b = kw.pop("m"), kw.pop("b")
    rs = np.random.default_rng(m * 100 + b)
    sg, sm, bm, bg, ok = profiling.intake_arrays(rs, 203, m, b, **kw)
    rest = [np.zeros_like(sg)] * 4
    want_in = ref(jintake.in_store, jstore.StoreCols(sg, sm, *rest), bm, bg,
                  impl=impl)
    want_dup = ref(jintake.dup_earlier, bm, bg, ok, impl=impl)
    got = intake.intake_checks(*map(to_t, (sg, sm, bm, bg, ok)))
    same(got, [want_in, want_dup])
    same([intake.dup_earlier(*map(to_t, (bm, bg, ok)))], [want_dup])
    assert to_np(got[1]).any() == (b > 1)


# ---- candidates (no TPU-only form: plain PyTorch everywhere) -------------------

CAND_CFG = dict(n_peers=64, n_trackers=3, k_candidates=12, forward_fanout=4)


def table(rs, n, k, now):
    peer = rs.integers(-1, n, size=(n, k)).astype(np.int32)
    stamps = [np.where(rs.random((n, k)) < 0.5,
                       now - rs.integers(0, 80, size=(n, k)) * 5.0,
                       -1.0e9).astype(np.float32) for _ in range(3)]
    return [peer] + stamps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidates(seed):
    rs = np.random.default_rng(seed)
    jc, pc = JaxConfig(**CAND_CFG), CommunityConfig(**CAND_CFG)
    n, k = pc.n_peers, pc.k_candidates
    now = np.float32(400.0)
    tab = table(rs, n, k, now)
    jt = jcand.CandTable(*map(jnp.asarray, tab))
    pt = cand.CandTable(*map(to_t, tab))
    jnow, pnow = jnp.float32(now), torch.tensor(now)
    idx = np.arange(n, dtype=np.int32)
    key = np.array([3, 7 + seed], np.uint32)
    jseed, pseed = jrng.fold_seed(jnp.asarray(key)), rng.fold_seed(
        torch.from_numpy(key.astype(np.int64)))
    jr, pr = jnp.uint32(11 + seed), torch.tensor(11 + seed)

    cats = cand.categories(pt, pnow, pc)
    same([cats], [ref(jcand.categories, jt, jnow, jc)])
    same([cand.is_eligible(pt, cats, pnow, pc)],
         [ref(jcand.is_eligible, jt, to_np(cats), jnow, jc)])
    boot_b = np.zeros(n, np.int32)
    boot_c = np.full(n, pc.n_trackers, np.int32)
    same([cand.sample_walk_target(pt, pnow, pc, pseed, pr, to_t(idx),
                                  to_t(boot_b), to_t(boot_c))],
         [ref(jcand.sample_walk_target, jt, jnow, jc, jseed, jr, idx,
              boot_b, boot_c)])
    same([cand.sample_forward_targets(pt, pnow, pc, pseed, pr, to_t(idx))],
         [ref(jcand.sample_forward_targets, jt, jnow, jc, jseed, jr, idx)])
    excl = rs.integers(-1, n, size=(n, 5)).astype(np.int32)
    same([cand.sample_introductions(pt, pnow, pc, pseed, pr, to_t(idx),
                                    to_t(excl), salt_base=1 << 20)],
         [ref(jcand.sample_introductions, jt, jnow, jc, jseed, jr, idx,
              excl, salt_base=1 << 20)])
    upd = rs.integers(-1, n, size=(n, 6)).astype(np.int32)
    upd[:, 3] = upd[:, 1]                   # a repeat inside one batch
    kind = rs.integers(0, 3, size=(n, 6)).astype(np.int32)
    ok = rs.random((n, 6)) < 0.8
    same(cand.upsert_many(pt, to_t(upd), to_t(kind), to_t(ok), pnow,
                          to_t(idx), n_trackers=pc.n_trackers),
         ref(jcand.upsert_many, jt, upd, kind, ok, jnow, idx,
             n_trackers=jc.n_trackers))
    gone = tab[0][:, 0].copy()
    kill = rs.random(n) < 0.5
    same(cand.remove(pt, to_t(gone), to_t(kill)),
         ref(jcand.remove, jt, gone, kill))


# ---- the byte-diet round's call shapes ----------------------------------------

def _salts(rs, n, kind):
    """(port salt, JAX salt): none, one u32 for all rows, or one per row
    (JAX broadcasts an [N, 1] column, as the engine passes its epochs)."""
    if kind == "none":
        return None, None
    if kind == "scalar":
        v = np.array(0xFFFFFFFE, np.uint32)     # a wrapped epoch + 1
        return to_t(v), jnp.uint32(v)
    v = u32(rs, n, hi=5)
    v[::4] = 0xFFFFFFFF
    return to_t(v), jnp.asarray(v)[:, None]


@pytest.mark.parametrize("n,m,w,k", BLOOM_SHAPES)
@pytest.mark.parametrize("salt_kind", ["none", "scalar", "row"])
def test_digest_update_and_row_salts(n, m, w, k, salt_kind):
    rs = np.random.default_rng(n + m + w + k)
    bits = 32 * w
    ps, js = _salts(rs, n, salt_kind)
    dig = np.where(rs.random((n, w)) < 0.2, u32(rs, n, w), 0).astype(
        np.uint32)
    h = u32(rs, n, m)
    mask = rs.random((n, m)) < 0.5
    got = bloom.digest_update(to_t(dig), to_t(h), to_t(mask), bits, k,
                              salt=ps)
    # The gather form the JAX engine runs on the CPU ...
    same([got], [ref(lambda d, h, m, s: jbloom.digest_update(
        d, jbloom.probe_bits(h, bits, k, s), m, bits), dig, h, mask, js)])
    # ... and the compare form (dig | bloom_build) of the TPU.
    for impl in ("gather", "compare"):
        same([got], [ref(lambda d, h, m, s: d | jbloom.bloom_build(
            h, m, bits, k, impl=impl, salt=s), dig, h, mask, js)])
    same([bloom.probe_bits(to_t(h), bits, k, ps).to(torch.int32)],
         [ref(jbloom.probe_bits, h, bits, k, js)])
    # Queries at the same salts: the freshness test against the digest.
    q = np.where(rs.random((n, m)) < 0.5, h, u32(rs, n, m))
    present = bloom.bloom_query(got, to_t(q), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([present], [ref(jbloom.bloom_query, to_np(got), q, bits, k,
                             impl=impl, salt=js)])
    assert to_np(present)[mask & (q == h)].all()
    assert not np.array_equal(to_np(got), dig) or not mask.any()


STAGE_SHAPES = [  # (N, S, B, p_mask, live fill or "holes" / "full")
    (DIMS["N"], DIMS["M"], DIMS["B"], 0.7, 0.5),
    (32, 8, 24, 0.3, 0.4),     # the bench shape: S = 8, B = b + push
    (16, 8, 24, 0.9, 0.9),     # overflow everywhere
    (12, 3, 40, 0.5, 0.0),     # an empty staging buffer, a wide batch
    (32, 8, 24, 0.4, "holes"),  # holes among the valid entries
    (16, 8, 24, 0.5, "full"),  # every row full: every arrival dropped
    (16, 32, 24, 0.6, 0.5),    # S = 32, the kernel's widest row
]


@pytest.mark.parametrize("n,s,b,p,fill", STAGE_SHAPES)
@pytest.mark.parametrize("aux16", [False, True])
def test_store_stage(n, s, b, p, fill, aux16):
    rs = np.random.default_rng(n * s + b)
    # A staging buffer with a valid prefix and EMPTY holes after it, with
    # holes among its valid entries (cnt counts them; arrivals overwrite
    # slot cnt + rank), or full.
    if fill in ("holes", "full"):
        cols = batch(rs, n, s)             # every slot a record
        live = rs.random((n, s)) < (0.6 if fill == "holes" else 2)
    else:
        cols = ring(rs, n, s)
        live = np.arange(s)[None, :] < (rs.random(n) * (s + 1) * fill
                                        ).astype(int)[:, None]
    for c, empty in zip(range(6), (U32_MAX, U32_MAX, 255, U32_MAX, 0, 0)):
        cols[c] = np.where(live, cols[c], empty).astype(cols[c].dtype)
    if aux16:
        cols[4] = cols[4].astype(np.uint16)
    bt = batch(rs, n, b)
    bt[4] = u32(rs, n, b)                  # full-width aux: narrowed
    mask = rs.random((n, b)) < p           # holes in the batch
    want = ref(jstore.store_stage, jstore.StoreCols(*cols),
               jstore.StoreCols(*bt), mask)
    got = st.store_stage(st.StoreCols(*map(to_t, cols)),
                         st.StoreCols(*map(to_t, bt)), to_t(mask))
    same(got.staging, want.staging)
    same(got[1:], want[1:])
    if p > 0.8 or fill == "full":
        assert to_np(got.n_dropped).sum() > 0


@pytest.mark.parametrize("a", [0, 3])
def test_cohort_take_put(a):
    rs = np.random.default_rng(a)
    n, coh = 24, 4
    for col in (u32(rs, n, 6), u32(rs, n, 5).astype(np.uint16),
                rs.random((n, 3)) < 0.5, u32(rs, n)):
        blk = np.asarray(jstore.cohort_take(jnp.asarray(col), jnp.uint32(a),
                                            coh))
        pt = to_t(col)
        same([st.cohort_take(pt, a, coh)], [blk])
        new = np.flip(blk, axis=0).copy()
        before = to_np(pt).copy()
        got = st.cohort_put(pt, to_t(new), a, coh)
        same([got], [jstore.cohort_put(jnp.asarray(col), jnp.asarray(new),
                                       jnp.uint32(a), coh)])
        same([pt], [before])               # the caller's tensor is kept
        mine = to_t(col)
        assert st.cohort_set(mine, to_t(new), a, coh) is mine
        same([mine], [got])                # written in place
    cols = st.StoreCols(*map(to_t, ring(rs, n, 6)))
    blk = st.cohort_take_cols(cols, a, coh)
    assert all(c.is_contiguous() for c in blk)
    same(st.cohort_put_cols(cols, blk, a, coh), cols)


@pytest.mark.parametrize("n,m,b,keys", STORE_SHAPES)
def test_store_insert_u16_aux(n, m, b, keys):
    """The staggered compaction: ring and staging with u16 aux; and the
    create_messages batch, whose u32 aux narrows to the ring's u16."""
    rs = np.random.default_rng(n + m + b + keys)
    s = ring(rs, n, m, keys)
    s[4] = (s[4].astype(np.uint32) * 30000).astype(np.uint16)
    for aux_dt in (np.uint16, np.uint32):
        bt = batch(rs, n, b, keys)
        bt[4] = u32(rs, n, b).astype(aux_dt)
        mask = rs.random((n, b)) < 0.7
        want = ref(jstore.store_insert, jstore.StoreCols(*s),
                   jstore.StoreCols(*bt), mask)
        got = st.store_insert(st.StoreCols(*map(to_t, s)),
                              st.StoreCols(*map(to_t, bt)), to_t(mask))
        assert got.store.aux.dtype == torch.uint16
        same(got.store, want.store)
        same(got[1:], want[1:])


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_rank_compact_many_u16(impl):
    """The serve outbox and the forward buffer with a u16 aux column."""
    rs = np.random.default_rng(7)
    n, w, width = 24, 48, 8
    live = rs.random((n, w)) < 0.3
    rank = np.cumsum(live, axis=1) - 1
    slot = np.where(live & (rank < width), rank, width).astype(np.int32)
    cols = [(u32(rs, n, w), U32_MAX),
            (u32(rs, n, w).astype(np.uint16), 0),
            (u32(rs, n, w).astype(np.uint16), 0xFFFF),
            (rs.integers(0, 256, size=(n, w)).astype(np.uint8), 0xFF),
            (live, False)]
    want = ref(jstore.rank_compact_many, cols, slot, width, impl=impl)
    got = st.rank_compact_many([(to_t(c), f) for c, f in cols], to_t(slot),
                               width)
    same(got, want)


def test_deliver_u16_column():
    """The push blast with the u16 aux column of the diet's forward
    buffer, beside u32 and u8 columns."""
    rs = np.random.default_rng(11)
    e, n, q = 600, 40, 16
    dst = rs.integers(-1, n + 1, size=e).astype(np.int32)
    valid = rs.random(e) < 0.8
    cols = [u32(rs, e), rs.integers(0, 256, size=e).astype(np.uint8),
            u32(rs, e).astype(np.uint16)]
    want = ref(jinbox.deliver, dst, cols, valid, n, q)
    got = inbox.deliver(to_t(dst), [to_t(c) for c in cols], to_t(valid), n,
                        q)
    assert got.inbox[2].dtype == torch.uint16
    same(got.inbox, want.inbox)
    same(got[1:], want[1:])


@pytest.mark.parametrize("n,b", [(DIMS["N"], DIMS["B"]), (32, 24), (8, 40)])
@pytest.mark.parametrize("impl", ["broadcast", "chunked"])
def test_dup_earlier_without_store(n, b, impl):
    rs = np.random.default_rng(n * b)
    bg, bm = u32(rs, n, b, hi=12), u32(rs, n, b, hi=3)
    ok = rs.random((n, b)) < 0.7
    want = ref(jintake.dup_earlier, bm, bg, ok, impl=impl)
    got = intake.dup_earlier(to_t(bm), to_t(bg), to_t(ok))
    same([got], [want])
    if n * b > 100:
        assert to_np(got).any()

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

import numpy as np
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

from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.ops import bloom, inbox, intake, rng
from dispersy_tpu_torch.ops import candidates as cand
from dispersy_tpu_torch.ops import store as st

U32_MAX = 0xFFFFFFFF


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


def u32(rs, *shape, hi=1 << 32):
    return rs.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


# ---- K1 deliver -------------------------------------------------------------

DELIVER_SHAPES = [  # (E, N, Q, W, p_valid)
    (DIMS["E"], DIMS["N"], DIMS["Q"], DIMS["W"], 0.8),   # contract dims
    (200, 16, 3, 0, 0.9),      # overflow everywhere
    (333, 40, 5, 15, 0.5),     # the [E, 15] bloom column
    (1000, 3, 64, 0, 0.7),     # tracker-like: few large groups
]


@pytest.mark.parametrize("e,n,q,w,p", DELIVER_SHAPES)
def test_deliver(e, n, q, w, p):
    rs = np.random.default_rng(e + n)
    dst = rs.integers(-2, n + 2, size=e).astype(np.int32)  # parked ends
    valid = rs.random(e) < p
    cols = [np.arange(e, dtype=np.uint32), u32(rs, e),
            rs.integers(0, 256, size=e).astype(np.uint8),
            rs.random(e) < 0.5]
    if w:
        cols.append(u32(rs, e, w))
    want = jinbox.deliver(jnp.asarray(dst), [jnp.asarray(c) for c in cols],
                          jnp.asarray(valid), n, q)
    got = inbox.deliver(to_t(dst), [to_t(c) for c in cols], to_t(valid), n,
                        q)
    same(got.inbox, want.inbox)
    same(got[1:], want[1:])
    assert int(to_np(got.n_dropped).sum()) > 0 or e < n * q


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
         [jbloom.probe_bits(jnp.asarray(h), bits, k, js)])
    words = bloom.bloom_build(to_t(h), to_t(mask), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([words], [jbloom.bloom_build(jnp.asarray(h), jnp.asarray(mask),
                                          bits, k, impl=impl, salt=js)])
    q = np.where(rs.random((n, m)) < 0.5, h, u32(rs, n, m))
    got = bloom.bloom_query(words, to_t(q), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([got], [jbloom.bloom_query(jnp.asarray(to_np(words)),
                                        jnp.asarray(q), bits, k, impl=impl,
                                        salt=js)])
    dense = rs.random((n, bits)) < 0.3
    same([bloom.pack_bits(to_t(dense))],
         [jbloom.pack_bits(jnp.asarray(dense)).reshape(n, w)])
    same([bloom.unpack_bits(bloom.pack_bits(to_t(dense)))], [dense])


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
    want = jstore.store_insert(jstore.StoreCols(*map(jnp.asarray, s)),
                               jstore.StoreCols(*map(jnp.asarray, bt)),
                               jnp.asarray(mask))
    got = st.store_insert(st.StoreCols(*map(to_t, s)),
                          st.StoreCols(*map(to_t, bt)), to_t(mask))
    same(got.store, want.store)
    same(got[1:], want[1:])
    assert int(to_np(got.n_dropped).sum()) > 0   # dups or overflow hit


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
    want = jstore.rank_compact_many(
        [(jnp.asarray(c), f) for c, f in cols], jnp.asarray(slot), width,
        impl=impl)
    got = st.rank_compact_many([(to_t(c), f) for c, f in cols], to_t(slot),
                               width)
    same(got, want)
    same([st.rank_compact(to_t(cols[0][0]), to_t(slot), width, U32_MAX)],
         [jstore.rank_compact(jnp.asarray(cols[0][0]), jnp.asarray(slot),
                              width, U32_MAX)])


# ---- K5 intake checks ----------------------------------------------------------

@pytest.mark.parametrize("n,m,b", [(DIMS["N"], DIMS["M"], DIMS["B"]),
                                   (32, 48, 24), (8, 5, 40)])
@pytest.mark.parametrize("impl", ["broadcast", "chunked"])
def test_intake_checks(n, m, b, impl):
    rs = np.random.default_rng(n + m + b)
    s = ring(rs, n, m, keys=30, members=3)
    bg, bm = u32(rs, n, b, hi=30), u32(rs, n, b, hi=3)
    ok = rs.random((n, b)) < 0.7
    jstc = jstore.StoreCols(*map(jnp.asarray, s))
    want_in = jintake.in_store(jstc, jnp.asarray(bm), jnp.asarray(bg),
                               impl=impl)
    want_dup = jintake.dup_earlier(jnp.asarray(bm), jnp.asarray(bg),
                                   jnp.asarray(ok), impl=impl)
    pstc = st.StoreCols(*map(to_t, s))
    got = intake.intake_checks(pstc.gt, pstc.member, to_t(bm), to_t(bg),
                               to_t(ok))
    same(got, [want_in, want_dup])
    if n * b > 100:
        assert to_np(got[0]).any() and to_np(got[1]).any()


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
    same([cats], [jcand.categories(jt, jnow, jc)])
    same([cand.is_eligible(pt, cats, pnow, pc)],
         [jcand.is_eligible(jt, jnp.asarray(to_np(cats)), jnow, jc)])
    boot_b = np.zeros(n, np.int32)
    boot_c = np.full(n, pc.n_trackers, np.int32)
    same([cand.sample_walk_target(pt, pnow, pc, pseed, pr, to_t(idx),
                                  to_t(boot_b), to_t(boot_c))],
         [jcand.sample_walk_target(jt, jnow, jc, jseed, jr, jnp.asarray(idx),
                                   jnp.asarray(boot_b), jnp.asarray(boot_c))])
    same([cand.sample_forward_targets(pt, pnow, pc, pseed, pr, to_t(idx))],
         [jcand.sample_forward_targets(jt, jnow, jc, jseed, jr,
                                       jnp.asarray(idx))])
    excl = rs.integers(-1, n, size=(n, 5)).astype(np.int32)
    same([cand.sample_introductions(pt, pnow, pc, pseed, pr, to_t(idx),
                                    to_t(excl), salt_base=1 << 20)],
         [jcand.sample_introductions(jt, jnow, jc, jseed, jr,
                                     jnp.asarray(idx), jnp.asarray(excl),
                                     salt_base=1 << 20)])
    upd = rs.integers(-1, n, size=(n, 6)).astype(np.int32)
    upd[:, 3] = upd[:, 1]                   # a repeat inside one batch
    kind = rs.integers(0, 3, size=(n, 6)).astype(np.int32)
    ok = rs.random((n, 6)) < 0.8
    same(cand.upsert_many(pt, to_t(upd), to_t(kind), to_t(ok), pnow,
                          to_t(idx), n_trackers=pc.n_trackers),
         jcand.upsert_many(jt, jnp.asarray(upd), jnp.asarray(kind),
                           jnp.asarray(ok), jnow, jnp.asarray(idx),
                           n_trackers=jc.n_trackers))
    gone = tab[0][:, 0].copy()
    kill = rs.random(n) < 0.5
    same(cand.remove(pt, to_t(gone), to_t(kill)),
         jcand.remove(jt, jnp.asarray(gone), jnp.asarray(kill)))


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
    same([got], [jbloom.digest_update(
        jnp.asarray(dig), jbloom.probe_bits(jnp.asarray(h), bits, k, js),
        jnp.asarray(mask), bits)])
    # ... and the compare form (dig | bloom_build) of the TPU.
    for impl in ("gather", "compare"):
        same([got], [jnp.asarray(dig) | jbloom.bloom_build(
            jnp.asarray(h), jnp.asarray(mask), bits, k, impl=impl,
            salt=js)])
    same([bloom.probe_bits(to_t(h), bits, k, ps).to(torch.int32)],
         [jbloom.probe_bits(jnp.asarray(h), bits, k, js)])
    # Queries at the same salts: the freshness test against the digest.
    q = np.where(rs.random((n, m)) < 0.5, h, u32(rs, n, m))
    present = bloom.bloom_query(got, to_t(q), bits, k, salt=ps)
    for impl in ("gather", "compare"):
        same([present], [jbloom.bloom_query(jnp.asarray(to_np(got)),
                                            jnp.asarray(q), bits, k,
                                            impl=impl, salt=js)])
    assert to_np(present)[mask & (q == h)].all()
    assert not np.array_equal(to_np(got), dig) or not mask.any()


STAGE_SHAPES = [  # (N, S, B, p_mask, live fill)
    (DIMS["N"], DIMS["M"], DIMS["B"], 0.7, 0.5),
    (32, 8, 24, 0.3, 0.4),     # the bench shape: S = 8, B = b + push
    (16, 8, 24, 0.9, 0.9),     # overflow everywhere
    (12, 3, 40, 0.5, 0.0),     # an empty staging buffer, a wide batch
]


@pytest.mark.parametrize("n,s,b,p,fill", STAGE_SHAPES)
@pytest.mark.parametrize("aux16", [False, True])
def test_store_stage(n, s, b, p, fill, aux16):
    rs = np.random.default_rng(n * s + b)
    # A staging buffer with a valid prefix and EMPTY holes after it.
    cols = ring(rs, n, s)
    live = np.arange(s)[None, :] < (rs.random(n) * (s + 1) * fill).astype(
        int)[:, None]
    for c, empty in zip(range(6), (U32_MAX, U32_MAX, 255, U32_MAX, 0, 0)):
        cols[c] = np.where(live, cols[c], empty).astype(cols[c].dtype)
    if aux16:
        cols[4] = cols[4].astype(np.uint16)
    bt = batch(rs, n, b)
    bt[4] = u32(rs, n, b)                  # full-width aux: narrowed
    mask = rs.random((n, b)) < p           # holes in the batch
    want = jstore.store_stage(jstore.StoreCols(*map(jnp.asarray, cols)),
                              jstore.StoreCols(*map(jnp.asarray, bt)),
                              jnp.asarray(mask))
    got = st.store_stage(st.StoreCols(*map(to_t, cols)),
                         st.StoreCols(*map(to_t, bt)), to_t(mask))
    same(got.staging, want.staging)
    same(got[1:], want[1:])
    if p > 0.8:
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
        want = jstore.store_insert(jstore.StoreCols(*map(jnp.asarray, s)),
                                   jstore.StoreCols(*map(jnp.asarray, bt)),
                                   jnp.asarray(mask))
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
    want = jstore.rank_compact_many(
        [(jnp.asarray(c), f) for c, f in cols], jnp.asarray(slot), width,
        impl=impl)
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
    want = jinbox.deliver(jnp.asarray(dst), [jnp.asarray(c) for c in cols],
                          jnp.asarray(valid), n, q)
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
    want = jintake.dup_earlier(jnp.asarray(bm), jnp.asarray(bg),
                               jnp.asarray(ok), impl=impl)
    got = intake.dup_earlier(to_t(bm), to_t(bg), to_t(ok))
    same([got], [want])
    if n * b > 100:
        assert to_np(got).any()

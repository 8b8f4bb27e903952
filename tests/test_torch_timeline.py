"""The permissioned slice's ops: each plain version of the port against
the JAX package's op on the same numpy inputs, bit for bit (tolerance 0:
every op here is integer work).

The kernel ops -- K8 ``check`` / ``check_grant`` (``ops/timeline.py``),
K9's five store replays (``ops/intake.py``), K10 ``store_remove`` and K3
``store_insert`` with a LastSync ``history`` (``ops/store.py``) -- are held
against every form the JAX package has (its broadcast and chunked
forms; the store's sort and merge forms).  ``fold`` and ``revalidate``
have one form.  The random tables hold empty rows, revoke / grant ties at
one global time, metas out of the nibble range, the 0xFFFF not-found
sentinel and founder columns.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dispersy_tpu.ops import intake as jintake
from dispersy_tpu.ops import store as jstore
from dispersy_tpu.ops import timeline as jtl

from dispersy_tpu_torch.config import (META_AUTHORIZE, META_DYNAMIC,
                                       META_UNDO_OTHER, META_UNDO_OWN,
                                       PERM_AUTHORIZE, PERM_PERMIT,
                                       PERM_REVOKE, PERM_UNDO)
from dispersy_tpu_torch.ops import intake
from dispersy_tpu_torch.ops import store as st
from dispersy_tpu_torch.ops import timeline as tl
from test_torch_ops import (release_xla_executables,  # noqa: F401
                            same, to_np, to_t)

EMPTY = 0xFFFFFFFF


def jitted(fn, **static):
    """``fn`` with its static arguments bound, compiled as one program: one
    XLA compile per call instead of one per primitive of the eager form."""
    return jax.jit(lambda *args: fn(*args, **static))


def u32(rs, *shape, lo=0, hi=1 << 32):
    return rs.integers(lo, hi, size=shape, dtype=np.uint64).astype(np.uint32)


# ---- grant tables -------------------------------------------------------------

def table(rs, n, a, members=5, gts=12, fill=0.7):
    """[N, A] rows: members and global times from small ranges (so
    queries hit and grant / revoke rows tie at one gt), masks of random
    nibbles over 9 metas (bits past 31 fall off), empty rows and one
    all-empty table row."""
    live = rs.random((n, a)) < fill
    live[0] = False
    mask = np.zeros((n, a), np.uint64)
    for k in range(9):
        nib = rs.integers(0, 16, size=(n, a)) * (rs.random((n, a)) < 0.5)
        mask |= (nib.astype(np.uint64) << np.uint64(4 * k))
    cols = (np.where(live, u32(rs, n, a, hi=members), EMPTY).astype(np.uint32),
            (mask & 0xFFFFFFFF).astype(np.uint32),
            u32(rs, n, a, hi=gts),
            rs.random((n, a)) < 0.3,
            np.where(live, u32(rs, n, a, hi=members), EMPTY).astype(np.uint32))
    return cols


def jtab(cols):
    return jtl.AuthTable(*map(jnp.asarray, cols))


def ttab(cols):
    return tl.AuthTable(*map(to_t, cols))


# (N, A, Q): the intake batch's queries, and the author gate's one.
TABLE_SHAPES = [(33, 8, 24), (16, 3, 1)]


@pytest.mark.parametrize("n,a,q", TABLE_SHAPES)
def test_check(n, a, q):
    rs = np.random.default_rng(n * a + q)
    cols = table(rs, n, a)
    member = u32(rs, n, q, hi=6)
    meta = rs.choice(np.array([0, 1, 2, 3, 7, 8, 9, 0xF0, 0xFFFF],
                              np.uint32), size=(n, q))
    gt = u32(rs, n, q, hi=14)
    founder_col = u32(rs, n, 1, hi=6)
    for perm, founder in ((PERM_PERMIT, 4), (PERM_AUTHORIZE, founder_col),
                          (PERM_REVOKE, 4), (PERM_UNDO, founder_col)):
        want = jitted(jtl.check, perm=perm)(
            jtab(cols), jnp.asarray(member), jnp.asarray(meta),
            jnp.asarray(gt), jnp.asarray(founder))
        tf = founder if isinstance(founder, int) else to_t(founder)
        got = tl.check(ttab(cols), to_t(member), to_t(meta), to_t(gt), tf,
                       perm=perm)
        same([got], [want])
        # The u8 meta column of a store (the retro pass's query).
        got8 = tl.check(ttab(cols), to_t(member),
                        to_t(np.minimum(meta, 255).astype(np.uint8)),
                        to_t(gt), tf, perm=perm)
        want8 = jitted(jtl.check, perm=perm)(
            jtab(cols), jnp.asarray(member),
            jnp.asarray(np.minimum(meta, 255).astype(np.uint8)),
            jnp.asarray(gt), jnp.asarray(founder))
        same([got8], [want8])
    assert 0 < int(to_np(got).sum()) < n * q


@pytest.mark.parametrize("n,a,q", TABLE_SHAPES)
def test_check_grant(n, a, q):
    rs = np.random.default_rng(n + a * q)
    cols = table(rs, n, a)
    member = u32(rs, n, q, hi=6)
    nib = rs.integers(0, 16, size=(n, q, 3)) * (rs.random((n, q, 3)) < 0.4)
    mask = (nib[..., 0] | (nib[..., 1] << 4) | (nib[..., 2] << 28)).astype(
        np.uint32)                          # metas 0, 1 and 7; some empty
    gt = u32(rs, n, q, hi=14)
    for perm, n_meta, impl in ((PERM_AUTHORIZE, 3, "broadcast"),
                               (PERM_AUTHORIZE, 9, "chunked"),
                               (PERM_REVOKE, 9, "broadcast"),
                               (PERM_REVOKE, 3, "chunked")):
        got = tl.check_grant(ttab(cols), to_t(member), to_t(mask), to_t(gt),
                             n_meta, perm=perm)
        want = jitted(jtl.check_grant, n_meta=n_meta, perm=perm, impl=impl)(
            jtab(cols), jnp.asarray(member), jnp.asarray(mask),
            jnp.asarray(gt))
        same([got], [want])
    assert int(to_np(got).sum()) > 0


@pytest.mark.parametrize("n,a,b,fill", [(24, 8, 6, 0.6), (12, 4, 9, 1.0)])
def test_fold(n, a, b, fill):
    """Free slots first, then the top-A window (evictions and drops),
    idempotent on an identical row; batches with duplicates."""
    rs = np.random.default_rng(n * a + b)
    cols = table(rs, n, a, fill=fill)
    target = u32(rs, n, b, hi=5)
    mask = u32(rs, n, b, hi=1 << 12)
    gt = u32(rs, n, b, hi=12)
    is_rev = rs.random((n, b)) < 0.3
    valid = rs.random((n, b)) < 0.8
    issuer = u32(rs, n, b, hi=5)
    # Some batch entries repeat a table row exactly (a no-op re-fold).
    rep = (rs.random(n) < 0.5) & (cols[0][:, 1] != EMPTY)
    target[rep, 0], mask[rep, 0], gt[rep, 0] = (cols[0][rep, 1],
                                                cols[1][rep, 1],
                                                cols[2][rep, 1])
    is_rev[rep, 0], issuer[rep, 0] = cols[3][rep, 1], cols[4][rep, 1]
    valid[rep, 0] = True
    args = (target, mask, gt, is_rev, valid, issuer)
    want = jitted(jtl.fold)(jtab(cols), *map(jnp.asarray, args))
    got = tl.fold(ttab(cols), *map(to_t, args))
    same(got.table, want.table)
    same(got[1:], want[1:])
    if fill == 1.0:
        assert int(to_np(got.n_evicted).sum()) > 0
        assert int(to_np(got.n_dropped).sum()) > 0


@pytest.mark.parametrize("n,a,n_meta", [(40, 8, 3), (16, 6, 9)])
def test_revalidate(n, a, n_meta):
    """Chains through member ids 0..4 with founder 0 (int and column);
    the unwinding is transitive."""
    rs = np.random.default_rng(n + a + n_meta)
    cols = list(table(rs, n, a, fill=0.9))
    cols[3] = rs.random((n, a)) < 0.15
    for founder in (0, np.zeros(n, np.uint32)):
        want = jitted(jtl.revalidate, n_meta=n_meta)(jtab(cols),
                                                     jnp.asarray(founder))
        tf = founder if isinstance(founder, int) else to_t(founder)
        got = tl.revalidate(ttab(cols), tf, n_meta)
        same([got], [want])
    live = cols[0] != EMPTY
    kept = to_np(got)
    assert kept.sum() > 0 and (live & ~kept).sum() > 0


# ---- the store replays (K9) ---------------------------------------------------

def store_rows(rs, n, m, aux16=False):
    """A store with dynamic flips, undo records and user records whose
    keys collide with the queries."""
    live = rs.random((n, m)) < 0.8
    meta = rs.choice(np.array([0, 1, 2, 5, META_DYNAMIC, META_UNDO_OWN,
                               META_UNDO_OTHER, META_AUTHORIZE], np.uint8),
                     size=(n, m))
    cols = [np.where(live, u32(rs, n, m, hi=10), EMPTY).astype(np.uint32),
            np.where(live, u32(rs, n, m, hi=5), EMPTY).astype(np.uint32),
            np.where(live, meta, 255).astype(np.uint8),
            np.where(live, u32(rs, n, m, hi=5), EMPTY).astype(np.uint32),
            np.where(live, u32(rs, n, m, hi=10), 0).astype(np.uint32),
            np.zeros((n, m), np.uint8)]
    # A few huge global times: the flip key gt * 2 wraps in u32.
    big = live & (rs.random((n, m)) < 0.1)
    cols[0] = np.where(big, u32(rs, n, m, lo=1 << 31), cols[0])
    if aux16:
        cols[4] = cols[4].astype(np.uint16)
    return cols


def jstc(cols):
    return jstore.StoreCols(*map(jnp.asarray, cols))


def tstc(cols):
    return st.StoreCols(*map(to_t, cols))


# (N, M, Q): the intake's queries, the author gate's one, the retro
# pass's (the ring's own rows).
REPLAY_SHAPES = [(30, 48, 24), (11, 7, 1), (12, 48, 48)]


@pytest.mark.parametrize("n,m,q", REPLAY_SHAPES)
def test_store_replays(n, m, q):
    rs = np.random.default_rng(n * m + q)
    s = store_rows(rs, n, m)
    member = u32(rs, n, q, hi=5)
    gt = np.where(rs.random((n, q)) < 0.1, u32(rs, n, q, lo=1 << 31),
                  u32(rs, n, q, hi=10)).astype(np.uint32)
    q_meta8 = rs.integers(0, 6, size=(n, q)).astype(np.uint8)
    for impl in ("broadcast", "chunked"):
        js_, ts = jstc(s), tstc(s)
        same([intake.flip_best(ts, to_t(q_meta8), to_t(gt))],
             [jitted(jintake.flip_best, impl=impl)(
                 js_, jnp.asarray(q_meta8), jnp.asarray(gt))])
        same([intake.undo_marked(ts, to_t(member), to_t(gt))],
             [jitted(jintake.undo_marked, impl=impl)(
                 js_, jnp.asarray(member), jnp.asarray(gt))])
        same([intake.stored_meta_of(ts, to_t(member), to_t(gt))],
             [jitted(jintake.stored_meta_of, impl=impl)(
                 js_, jnp.asarray(member), jnp.asarray(gt))])
        # The batch-side flip replay, its reduce axis the batch.
        flip_ok = rs.random((n, q)) < 0.5
        pay, bgt, baux = u32(rs, n, q, hi=6), gt, u32(rs, n, q, hi=4)
        same([intake.flip_best_batch(to_t(flip_ok), to_t(pay), to_t(bgt),
                                     to_t(baux), to_t(q_meta8), to_t(gt))],
             [jitted(jintake.flip_best_batch, impl=impl)(*map(jnp.asarray, (
                 flip_ok, pay, bgt, baux, q_meta8, gt)))])
        valid = rs.random((n, q)) < 0.6
        same([intake.undo_hits_store(ts, to_t(member), to_t(gt),
                                     to_t(valid))],
             [jitted(jintake.undo_hits_store, impl=impl)(
                 js_, jnp.asarray(member), jnp.asarray(gt),
                 jnp.asarray(valid))])
    hits = to_np(intake.stored_meta_of(tstc(s), to_t(member), to_t(gt)))
    assert (hits == 0xFFFF).any() and (hits < 32).any()


@pytest.mark.parametrize("select", ["none", "every"])
def test_store_replays_select_none_or_every(select):
    """K9's selecting column at its extremes: no ring row (nor batch
    entry) is a flip, an undo or a user record -- or every one is -- so
    each replay compares nothing, or every slot."""
    n, m, q = 12, 48, 24
    rs = np.random.default_rng(7 + len(select))
    s = store_rows(rs, n, m)
    live = s[0] != EMPTY
    for meta, name in ((255, "none"), (META_DYNAMIC, "flip"),
                       (META_UNDO_OWN, "undo"), (1, "user")):
        if (select == "none") != (name == "none"):
            continue
        s[2] = np.where(live | (select == "every"), meta, 255).astype(
            np.uint8)
        member = u32(rs, n, q, hi=5)
        gt = u32(rs, n, q, hi=10)
        q_meta8 = rs.integers(0, 6, size=(n, q)).astype(np.uint8)
        js_, ts = jstc(s), tstc(s)
        same([intake.flip_best(ts, to_t(q_meta8), to_t(gt))],
             [jitted(jintake.flip_best, impl="broadcast")(
                 js_, jnp.asarray(q_meta8), jnp.asarray(gt))])
        same([intake.undo_marked(ts, to_t(member), to_t(gt))],
             [jitted(jintake.undo_marked, impl="broadcast")(
                 js_, jnp.asarray(member), jnp.asarray(gt))])
        same([intake.stored_meta_of(ts, to_t(member), to_t(gt))],
             [jitted(jintake.stored_meta_of, impl="broadcast")(
                 js_, jnp.asarray(member), jnp.asarray(gt))])
        valid = np.full((n, q), select == "every")
        same([intake.undo_hits_store(ts, to_t(member), to_t(gt),
                                     to_t(valid))],
             [jitted(jintake.undo_hits_store, impl="broadcast")(
                 js_, jnp.asarray(member), jnp.asarray(gt),
                 jnp.asarray(valid))])


# ---- K10 store_remove and K3 with a history ------------------------------------

def ring(rs, n, m, keys=30, members=4, metas=3, aux16=False):
    """Sorted rings (gt, member) with holes at the end."""
    g = rs.integers(1, keys, size=(n, m))
    mem = rs.integers(0, members, size=(n, m))
    order = np.lexsort((mem, g), axis=1)
    g, mem = (np.take_along_axis(x, order, 1) for x in (g, mem))
    dup = np.zeros((n, m), bool)
    dup[:, 1:] = (g[:, 1:] == g[:, :-1]) & (mem[:, 1:] == mem[:, :-1])
    live = (np.arange(m)[None, :] < rs.integers(0, m + 1, size=n)[:, None])
    live &= ~dup
    keep = np.argsort(~live, axis=1, kind="stable")
    g, mem, live = (np.take_along_axis(x, keep, 1) for x in (g, mem, live))
    aux = u32(rs, n, m, hi=1 << 20)
    cols = [np.where(live, g, EMPTY).astype(np.uint32),
            np.where(live, mem, EMPTY).astype(np.uint32),
            np.where(live, rs.integers(0, metas, size=(n, m)), 255).astype(
                np.uint8),
            np.where(live, u32(rs, n, m), EMPTY).astype(np.uint32),
            np.where(live, aux, 0).astype(np.uint16 if aux16 else np.uint32),
            np.where(live, rs.integers(0, 2, size=(n, m)), 0).astype(
                np.uint8)]
    return cols


@pytest.mark.parametrize("n,m,aux16", [(40, 48, False), (9, 5, True)])
def test_store_remove(n, m, aux16):
    rs = np.random.default_rng(n + m + aux16)
    s = ring(rs, n, m, aux16=aux16)
    kill = rs.random((n, m)) < 0.3
    want = jitted(jstore.store_remove)(jstc(s), jnp.asarray(kill))
    got = st.store_remove(tstc(s), to_t(kill))
    same(got.store, want.store)
    same([got.n_removed], [want.n_removed])
    assert int(to_np(got.n_removed).sum()) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_store_insert_history_spans_ring_and_batch(k):
    """LastSync groups whose records sit on both sides of the merge: the
    batch re-sends (member, meta) groups the ring holds, at global times
    below, between and above the stored ones, so a kept-k group loses
    records of the ring, of the batch, or of both (k = 1 and 2)."""
    n, m, b = 16, 24, 12
    history = (k, 0, k)
    rs = np.random.default_rng(40 + k)
    s = ring(rs, n, m, keys=40, members=2, metas=3)
    bt = ring(rs, n, b, keys=40, members=2, metas=3)
    bt[0] = np.where(bt[0] == EMPTY, u32(rs, n, b, lo=1, hi=40), bt[0])
    bt[1] = np.where(bt[1] == EMPTY, u32(rs, n, b, hi=2), bt[1])
    bt[2] = np.where(bt[2] == 255, rs.integers(0, 3, size=(n, b)),
                     bt[2]).astype(np.uint8)
    bt[4] = u32(rs, n, b, hi=1 << 20)
    mask = rs.random((n, b)) < 0.9
    want = jitted(jstore.store_insert, history=history)(
        jstc(s), jstc(bt), jnp.asarray(mask))
    got = st.store_insert(tstc(s), tstc(bt), to_t(mask), history=history)
    same(got.store, want.store)
    same(got[1:], want[1:])
    # Both sides lost records to the history, in one row at least.
    plain = st.store_insert(tstc(s), tstc(bt), to_t(mask))
    ev = to_np(got.n_evicted) > to_np(plain.n_evicted)
    dr = to_np(got.n_dropped) > to_np(plain.n_dropped)
    assert (ev & dr).any()


HISTORY_SHAPES = [  # (N, M, B, history, u16 aux)
    (24, 48, 24, (0, 0, 1), False),    # the permissioned ring and intake
    (12, 48, 8, (0, 1), True),         # a diet compaction
    (16, 12, 8, (2, 1, 3), True),      # every meta LastSync, overflow
    (16, 10, 1, (1, 1, 1), False),     # create_messages' one record
]


@pytest.mark.parametrize("n,m,b,history,aux16", HISTORY_SHAPES)
@pytest.mark.parametrize("merge", [False, True])
def test_store_insert_history(n, m, b, history, aux16, merge, monkeypatch):
    """K3's LastSync keep-last-k against both JAX store forms, with u32
    and u16 aux; metas past the history length keep everything."""
    monkeypatch.setattr(jstore, "_prefer_merge", lambda width: merge)
    rs = np.random.default_rng(n * m + b + len(history) + aux16)
    s = ring(rs, n, m, metas=len(history) + 1, aux16=aux16)
    bt = ring(rs, n, b, metas=len(history) + 1)
    bt[4] = u32(rs, n, b, hi=1 << 20)
    # Re-deliveries of stored keys (dups) and arrivals older and newer
    # than the stored members' records.
    take = rs.random((n, b)) < 0.3
    src = rs.integers(0, m, size=(n, b))
    rows = np.arange(n)[:, None]
    for c in (0, 1):
        bt[c] = np.where(take & (s[0][rows, src] != EMPTY), s[c][rows, src],
                         bt[c])
    bt[0] = np.where(bt[0] == EMPTY, u32(rs, n, b, lo=1, hi=30), bt[0])
    bt[1] = np.where(bt[1] == EMPTY, u32(rs, n, b, hi=4), bt[1])
    bt[2] = np.where(bt[2] == 255, 0, bt[2]).astype(np.uint8)
    mask = rs.random((n, b)) < 0.8
    want = jitted(jstore.store_insert, history=history)(
        jstc(s), jstc(bt), jnp.asarray(mask))
    got = st.store_insert(tstc(s), tstc(bt), to_t(mask), history=history)
    same(got.store, want.store)
    same(got[1:], want[1:])
    plain = st.store_insert(tstc(s), tstc(bt), to_t(mask))

    def lost(r):
        return int(to_np(r.n_evicted).sum() + to_np(r.n_dropped).sum())
    assert lost(got) > lost(plain)          # the history killed records

"""The hardened community: the identity gate, sequence-numbered sync and
double-sign conviction with malicious-proof gossip, held bit for bit
against the JAX package (tolerance 0: every op here is integer work).

The ops first -- K11's three store probes (``conflict``,
``identity_stored``, ``seq_stored_max``; their plain versions against
both forms of the JAX op), ``fold_set``, the key derivation and
``create_identities``, the sequence stamp of ``create_messages`` -- then
the rounds: ``profiling.hardened_config`` driven by
``profiling.hardened_schedule`` (identities over rounds 0-3, posts, the
sequence chain, the round-4 equivocations), clean and with churn and
loss, and the three features together with the Timeline, every leaf
after every create and every round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispersy_tpu import crypto as jcrypto
from dispersy_tpu import engine as jeng
from dispersy_tpu import state as jstate
from dispersy_tpu.ops import intake as jintake
from dispersy_tpu.ops import store as jstore
from dispersy_tpu.ops import timeline as jtl

from dispersy_tpu_torch import crypto, engine, init_state, profiling
from dispersy_tpu_torch.bridge import assert_states_equal, state_to_numpy
from dispersy_tpu_torch.config import META_IDENTITY, META_MALICIOUS
from dispersy_tpu_torch.ops import intake
from dispersy_tpu_torch.ops import store as st
from dispersy_tpu_torch.ops import timeline as tl
from test_torch_ops import (ref, release_xla_executables,  # noqa: F401
                            same, to_np, to_t)
from test_torch_step import jax_config, run_both
from test_torch_timeline import jitted

EMPTY = 0xFFFFFFFF


# ---- K11's plain versions -------------------------------------------------------

# Global times and payloads drawn from small sets with values at and above
# 2^31, so keys collide and the unsigned order matters.
GTS = np.array([1, 2, 3, 1 << 31, (1 << 31) + 5, EMPTY - 1], np.uint32)
METAS = np.array([0, 1, 2, META_IDENTITY, META_MALICIOUS], np.uint8)


def probe_inputs(rs, n, m, b, corner=None):
    """A store with empty slots (and one all-empty row) and a batch whose
    entries copy a store row (then maybe change meta, payload or aux) or
    draw fresh keys, so every probe answers both ways.  ``corner``:
    ``"shared_key"`` gives every slot of a row one live (member, gt),
    ``"high_aux"`` draws every aux at or above 2^31, ``"identity_empty"``
    puts identity metas and small members on the EMPTY-gt slots."""
    live = rs.random((n, m)) < 0.75
    live[0] = False
    s_gt = np.where(live, rs.choice(GTS, size=(n, m)), EMPTY).astype(
        np.uint32)
    s_member = np.where(live, rs.integers(0, 4, size=(n, m)), EMPTY).astype(
        np.uint32)
    s_meta = np.where(live, rs.choice(METAS, size=(n, m)), 0xFF).astype(
        np.uint8)
    s_payload = rs.choice(GTS, size=(n, m)).astype(np.uint32)
    s_aux = rs.integers(0, 1 << 32, size=(n, m), dtype=np.uint64).astype(
        np.uint32)
    s_aux[rs.random((n, m)) < 0.5] = rs.choice(GTS, size=1)[0]
    if corner == "shared_key":
        s_gt[:] = rs.choice(GTS[:-1], size=(n, 1))
        s_member[:] = rs.integers(0, 4, size=(n, 1))
    elif corner == "high_aux":
        s_aux = rs.integers(1 << 31, 1 << 32, size=(n, m),
                            dtype=np.uint64).astype(np.uint32)
    elif corner == "identity_empty":
        s_meta[~live] = META_IDENTITY
        s_member[~live] = rs.integers(0, 4, size=int((~live).sum()))
    stc = [s_gt, s_member, s_meta, s_payload, s_aux,
           np.zeros((n, m), np.uint8)]
    pick = rs.integers(0, m, size=(n, b))
    rows = np.arange(n)[:, None]
    q = [c[rows, pick].copy() for c in (s_member, s_gt, s_meta, s_payload,
                                        s_aux)]
    fresh = rs.random((n, b)) < 0.3
    q[0] = np.where(fresh, rs.integers(0, 5, size=(n, b)), q[0]).astype(
        np.uint32)
    q[1] = np.where(fresh, rs.choice(GTS, size=(n, b)), q[1]).astype(
        np.uint32)
    for i, pool in ((2, METAS), (3, GTS), (4, GTS)):
        change = rs.random((n, b)) < 0.2
        q[i] = np.where(change, rs.choice(pool, size=(n, b)), q[i]).astype(
            q[i].dtype)
    return stc, q


PROBE_SHAPES = [(40, 48, 24), (9, 5, 1)]   # (N, M, B): the slice's, and odd


@pytest.mark.parametrize("corner", [None, "shared_key", "high_aux",
                                    "identity_empty"])
@pytest.mark.parametrize("impl", ["broadcast", "chunked"])
@pytest.mark.parametrize("n,m,b", PROBE_SHAPES)
def test_store_probes_equal_jax(n, m, b, impl, corner):
    rs = np.random.default_rng(n * 100 + m + b)
    stc, (member, gt, meta, payload, aux) = probe_inputs(rs, n, m, b, corner)
    js_, ts = (jstore.StoreCols(*map(jnp.asarray, stc)),
               st.StoreCols(*map(to_t, stc)))
    got = [intake.conflict(ts, *map(to_t, (member, gt, meta, payload, aux))),
           intake.identity_stored(ts, to_t(member)),
           intake.seq_stored_max(ts, to_t(member), to_t(meta))]
    want = [jitted(jintake.conflict, impl=impl)(js_, *map(jnp.asarray, (
                member, gt, meta, payload, aux))),
            jitted(jintake.identity_stored, impl=impl)(js_,
                                                      jnp.asarray(member)),
            jitted(jintake.seq_stored_max, impl=impl)(
                js_, jnp.asarray(member), jnp.asarray(meta))]
    same(got, want)
    if b > 1:
        # Every probe answers true somewhere and the max reaches 2^31;
        # on the plain draw both answers of each probe occur.
        c, ident, best = (to_np(x) for x in got)
        assert c.any() and ident.any() and (best >= 1 << 31).any()
        if corner is None:
            assert not c.all() and not ident.all() and (best == 0).any()


def test_store_probe_wrapper_refuses_cpu_tensors():
    """K11's wrapper launches its kernel on CUDA tensors or raises: it
    never falls back to the plain version (the ops take that for a CPU
    tensor before they reach it)."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.exceptions import KernelError
    stc, q = probe_inputs(np.random.default_rng(0), 4, 6, 3)
    ts = st.StoreCols(*map(to_t, stc))
    with pytest.raises(KernelError, match="CUDA"):
        kernels.store_probe("identity", (ts.meta, ts.member), (to_t(q[0]),))
    with pytest.raises(KernelError, match="unknown mode"):
        kernels.store_probe("nope", (), ())


# ---- fold_set -------------------------------------------------------------------

@pytest.mark.parametrize("n,s,b,fill", [(30, 8, 24, 0.4), (12, 2, 9, 0.5),
                                        (5, 3, 0, 0.5)])
def test_fold_set_equals_jax(n, s, b, fill):
    """Members already held, repeated in the batch, and more new ones
    than free slots (overflow); folding the batch again inserts nothing."""
    rs = np.random.default_rng(n + s + b)
    tab = np.where(rs.random((n, s)) < fill, rs.integers(0, 6, size=(n, s)),
                   EMPTY).astype(np.uint32)
    member = rs.choice(np.array([0, 1, 2, 7, 8, 9, 1 << 31], np.uint32),
                       size=(n, b))
    valid = rs.random((n, b)) < 0.7
    got = tl.fold_set(to_t(tab), to_t(member), to_t(valid))
    want = jitted(jtl.fold_set)(*map(jnp.asarray, (tab, member, valid)))
    same(list(got), list(want))
    if b:
        assert to_np(got.n_inserted).any() and to_np(got.n_dropped).any()
    again = tl.fold_set(got.table, to_t(member), to_t(valid))
    same([again.table], [got.table])
    assert not to_np(again.n_inserted).any()


# ---- identities and the sequence stamp -------------------------------------------

def pair(pc, seed=3):
    jc = jax_config(pc)
    return (jc, ref(jstate.init_state, jc, jax.random.PRNGKey(seed)),
            init_state(pc, seed, device="cpu"))


def test_create_identities_equals_jax(monkeypatch):
    """The same registry seed gives the same keys (each security level),
    the same identity records and the same verification."""
    # The JAX package's create_identities through the compiled create.
    monkeypatch.setattr(jcrypto.engine, "create_messages",
                        jeng.create_messages_jit)
    for sec in ("very-low", "high"):
        a = jcrypto.MemberRegistry(b"seed-x", security=sec)
        b = crypto.MemberRegistry(b"seed-x", security=sec)
        for i in (0, 5, 63):
            assert a.member(i).mid == b.member(i).mid
            assert a.member(i).key.public == b.member(i).key.public
    pc = profiling.hardened_config(64)
    jc, js, ps = pair(pc)
    mask = (np.arange(64) % 3 == 1)
    jreg, preg = jcrypto.MemberRegistry(b"k"), crypto.MemberRegistry(b"k")
    js = jcrypto.create_identities(js, jc, jreg, jnp.asarray(mask))
    ps = crypto.create_identities(ps, pc, preg, torch.from_numpy(mask))
    assert_states_equal(ps, js, "create_identities")
    # Every non-tracker by default; a forged record fails verification.
    assert_states_equal(
        crypto.create_identities(ps, pc, preg),
        crypto.create_identities(ps, pc, preg, np.arange(64) >= 2),
        "create_identities, default mask")
    assert crypto.verify_identities(ps, pc, preg) == 1.0
    forged = ps.store_payload.view(torch.int32).clone()
    forged[(ps.store_meta == META_IDENTITY) & (ps.store_member.view(
        torch.int32) % 2 == 0)] = 7
    forged = forged.view(torch.uint32)
    bad = ps.replace(store_payload=forged)
    assert crypto.verify_identities(bad, pc, preg) == jcrypto.\
        verify_identities(js.replace(store_payload=jnp.asarray(
            to_np(forged))), jc, jreg) < 1.0


def test_sequence_stamp_of_create_messages():
    """A sequenced meta's create stamps one above the author's highest
    stored number (whatever aux the caller gives); another meta keeps the
    caller's aux."""
    pc = profiling.hardened_config(64)
    jc, js, ps = pair(pc)
    authors = np.arange(64) % 4 == 2
    for k, meta in enumerate([profiling.SEQ_TEXT, profiling.TEXT,
                              profiling.SEQ_TEXT, profiling.SEQ_TEXT]):
        pay = (np.arange(64) + 100 * k).astype(np.uint32)
        aux = np.full(64, 50 + k, np.uint32)
        js = jeng.create_messages_jit(js, jc, jnp.asarray(authors), meta,
                                      jnp.asarray(pay), jnp.asarray(aux))
        ps = engine.create_messages(ps, pc, torch.from_numpy(authors), meta,
                                    torch.from_numpy(pay.astype(np.int64)),
                                    torch.from_numpy(aux.astype(np.int64)))
        assert_states_equal(ps, js, f"create {k}")
    a = state_to_numpy(ps)
    r = int(np.flatnonzero(authors)[0])
    own = a["store_member"][r] == r
    seq = own & (a["store_meta"][r] == profiling.SEQ_TEXT)
    assert sorted(a["store_aux"][r][seq].tolist()) == [1, 2, 3]
    assert a["store_aux"][r][own & (a["store_meta"][r] == 0)].tolist() == [51]


# ---- the rounds -----------------------------------------------------------------

@pytest.fixture
def gate_counts(monkeypatch):
    """Count, in the port's rounds, the records the identity gate and the
    sequence chain reject (the port equals the JAX run leaf for leaf
    after every round, so these are the JAX run's rejections too)."""
    counts = {"identity": 0, "sequence": 0}
    gate, chain = engine._identity_gate, engine._seq_chain_ok

    def spy_gate(cfg, stc, batch, accept):
        out = gate(cfg, stc, batch, accept)
        counts["identity"] += int((accept & ~out).sum())
        return out

    def spy_chain(cfg, stc, batch, in_store, accept):
        ok = chain(cfg, stc, batch, in_store, accept)
        counts["sequence"] += int((accept & ~ok).sum())
        return ok
    monkeypatch.setattr(engine, "_identity_gate", spy_gate)
    monkeypatch.setattr(engine, "_seq_chain_ok", spy_chain)
    return counts


def jax_totals(js, *names):
    return {k: int(np.asarray(getattr(js.stats, k)).sum()) for k in names}


HARD_N, HARD_ROUNDS = 256, 20
HARD_CASES = {"hardened": {},
              "hardened_lossy_churn": dict(churn_rate=0.05, packet_loss=0.1)}


@pytest.mark.parametrize("case", sorted(HARD_CASES))
def test_hardened_rounds_equal_jax_every_leaf(case, gate_counts):
    """The schedule's creates, plants and rounds leave the port equal to
    the JAX package on every leaf and counter; the JAX run convicts
    (eyewitness and gossiped) and its identity gate and sequence chain
    reject records."""
    pc = profiling.hardened_config(HARD_N).replace(**HARD_CASES[case])
    _, _, js, ps, diffs = run_both(pc, HARD_ROUNDS,
                                   profiling.hardened_schedule(HARD_N))
    bad = [(where, d) for where, d in diffs if d is not None]
    assert not bad, f"{case}: {bad[0]}"
    tot = jax_totals(js, "conflicts", "convictions_rx", "msgs_rejected")
    assert tot["conflicts"] > 0 and tot["convictions_rx"] > 0, tot
    assert gate_counts["identity"] > 0 and gate_counts["sequence"] > 0
    assert tot["msgs_rejected"] > sum(gate_counts.values())  # + blacklist
    mal = np.asarray(js.mal_member)
    eq = np.flatnonzero(profiling.hardened_roles(HARD_N)["equivocators"])
    assert np.isin(mal, eq).any() and not np.isin(
        mal[mal != EMPTY], eq, invert=True).any()   # no false conviction
    proofs = np.asarray(js.store_meta) == META_MALICIOUS
    assert proofs.any()
    if case == "hardened_lossy_churn":
        assert int(np.asarray(js.session).sum()) > 0      # rebirths


def combination_schedule(n):
    """The permissioned schedule, with round-0 identities for its roles
    and every 64th peer, and the posts of every 64th peer equivocated in
    round 4 (each post claims 3, after the identity)."""
    roles = profiling.permissioned_roles(n)
    idx = np.arange(n)
    ids = (idx % 64 == 0) & (idx >= profiling.permissioned_config(n)
                             .n_trackers)
    ids[[roles["founder"], *roles["mods"], *roles["delegates"]]] = True
    mid = np.zeros(n, np.uint32)
    mid[ids] = crypto.MemberRegistry().mid32_of(np.flatnonzero(ids))
    out = [profiling.Create(0, META_IDENTITY, ids, mid,
                            np.zeros(n, np.uint32))]
    out += profiling.permissioned_schedule(n)
    out.append(profiling.Plant(4, (idx % 64 == 0) & ids,
                               np.full(n, 3, np.uint32), profiling.POST,
                               (idx + (1 << 31)).astype(np.uint32)))
    return sorted(out, key=lambda c: c.round)


def test_timeline_combination_equals_jax(gate_counts):
    """The three features on the permissioned community (sequence numbers
    on the pin): the intake runs killed, conviction, freshness, Timeline,
    identity, sequence, as the JAX package's; every leaf every round
    through the revoke's retro pass."""
    n, rounds = 256, 12
    pc = profiling.permissioned_config(n).replace(
        seq_meta_mask=0b010, identity_enabled=True, identity_required=True,
        malicious_enabled=True, malicious_gossip=True)
    _, _, js, ps, diffs = run_both(pc, rounds, combination_schedule(n))
    bad = [(where, d) for where, d in diffs if d is not None]
    assert not bad, bad[0]
    tot = jax_totals(js, "conflicts", "convictions_rx", "msgs_rejected",
                     "msgs_retro")
    assert all(v > 0 for v in tot.values()), tot
    assert gate_counts["identity"] > 0

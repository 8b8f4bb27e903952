"""The delay pen, its four request channels, double-signed and direct
metas, held bit for bit against the JAX package (tolerance 0 on every
PeerState leaf and counter after every event and every round, and on
``metrics.snapshot``).

Three configs, each compiled once on the JAX side: (a) the pen with all
four channels -- ``profiling.soak_config`` at 256 peers with 30% loss,
churn, the telemetry plane and 4 shards -- driven by
``profiling.soak_schedule``;
(b) the signature exchange on a protected dynamic double-signed meta
with ``countersign_rate=0.5``, after ``tests/test_signature.py``'s cases
(happy path, decline and expiry, both signers' permits, a synced copy
with a bogus countersigner, flips), with a direct meta beside it; (c)
the byte-diet store with a direct meta.  Each asserts that the counters
of its channels moved, so "equal" cannot mean "idle".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispersy_tpu import engine as jeng
from dispersy_tpu import state as jstate

from dispersy_tpu_torch import (create_signature_request, engine, init_state,
                                profiling)
from dispersy_tpu_torch.bridge import first_difference, state_to_numpy
from dispersy_tpu_torch.config import (META_AUTHORIZE, META_DYNAMIC,
                                       META_IDENTITY, META_UNDO_OTHER,
                                       perm_bit)
from dispersy_tpu_torch.planes import (ParallelConfig, StoreConfig,
                                       TelemetryConfig)
from test_torch_chaos import to_jax
from test_torch_ops import ref, release_xla_executables  # noqa: F401
from test_torch_step import same_snapshot

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)


def rows_of(state):
    """``pin_gt``'s row reader over either package's state."""
    def rows(ids):
        return tuple(np.asarray(state_to_numpy(state)[k])[ids]
                     for k in ("store_gt", "store_member", "store_meta"))
    return rows


def jax_event(js, jc, ev):
    """Apply one schedule event to the JAX state (the jitted forms
    compile once per (config, meta))."""
    if isinstance(ev, profiling.SigRequest):
        return jeng.create_signature_request_jit(
            js, jc, jnp.asarray(ev.authors), ev.meta,
            jnp.asarray(ev.counterparty), jnp.asarray(ev.payload))
    if isinstance(ev, profiling.Plant):
        cols = {k: np.asarray(getattr(js, f"fwd_{k}"))
                for k in profiling.FWD_COLS}
        new = profiling.plant_fwd(cols, ev)
        return js.replace(**{f"fwd_{k}": jnp.asarray(
            new[k].astype(cols[k].dtype)) for k in cols})
    if isinstance(ev, profiling.Undo):
        ids = np.arange(len(ev.authors), dtype=np.uint32)
        state = js

        def rows(sel):
            return tuple(np.asarray(getattr(state, k))[sel]
                         for k in ("store_gt", "store_member",
                                   "store_meta"))
        aux = profiling.pin_gt(ids, ev.authors, rows, ev.meta)
        ev = profiling.Create(ev.round, META_UNDO_OTHER, ev.authors, ids,
                              aux)
    return jeng.create_messages_jit(js, jc, jnp.asarray(ev.authors), ev.meta,
                                    jnp.asarray(ev.payload),
                                    jnp.asarray(ev.aux))


def run_events(pc, rounds, events, seed=5, degree=6):
    """Both packages from one seeded overlay through ``rounds`` rounds,
    each round's events (:func:`profiling.run_creates` on the port) made
    before its step; returns (JAX config, JAX state, port state, the
    first leaf difference after each round's events and each round)."""
    jc = to_jax(pc)
    js = ref(lambda key: jeng.seed_overlay(jstate.init_state(jc, key), jc,
                                           degree=degree),
             jax.random.PRNGKey(seed))
    ps = engine.seed_overlay(init_state(pc, seed, device="cpu"), pc, degree)
    diffs = []
    for rnd in range(rounds):
        for ev in events:
            if ev.round == rnd:
                js = jax_event(js, jc, ev)
        ps = profiling.run_creates(ps, pc, events, rnd)
        diffs.append((f"round {rnd} events", first_difference(
            state_to_numpy(ps), state_to_numpy(js))))
        js, ps = jeng.step(js, jc), engine.step(ps, pc)
        diffs.append((f"round {rnd}", first_difference(
            state_to_numpy(ps), state_to_numpy(js))))
    return jc, js, ps, diffs


def totals(ps, *names):
    return {k: int(getattr(ps.stats, k).view(torch.int32).to(
        torch.int64).sum()) for k in names}


PEN_COUNTERS = ("msgs_delayed", "proof_records", "seq_records", "mm_records",
                "id_records", "proof_requests", "seq_requests", "mm_requests",
                "id_requests")


def test_pen_channels_equal_jax():
    """(a): the soak community at 256 peers, 30% loss, churn, the
    telemetry plane (history 8) and the parallel plane (4 shards: every
    channel through the shard-local exchange): every leaf after every
    event and round, the snapshot at the end, and every channel's
    counter nonzero."""
    n = 256
    pc = profiling.soak_config(n).replace(
        packet_loss=0.3, churn_rate=0.03,
        telemetry=TelemetryConfig(enabled=True, history=8),
        parallel=ParallelConfig(shards=4))
    jc, js, ps, diffs = run_events(
        pc, 12, profiling.soak_schedule(n, seed=5, degree=6))
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    same_snapshot(ps, pc, js, jc)
    tot = totals(ps, *PEN_COUNTERS, "sig_done", "sig_expired", "msgs_direct")
    assert all(v > 0 for v in tot.values()), tot


# ---- (b) the signature exchange and a direct meta ------------------------------

DBL, DIRECT = 2, 5
SIG_CFG = profiling.slice_config(64).replace(
    n_trackers=2, k_candidates=8, msg_capacity=32, bloom_capacity=16,
    request_inbox=4, tracker_inbox=8, response_budget=4, n_meta=8,
    timeline_enabled=True, protected_meta_mask=1 << DBL,
    dynamic_meta_mask=1 << DBL, k_authorized=8, double_meta_mask=1 << DBL,
    direct_meta_mask=1 << DIRECT, countersign_rate=0.5, packet_loss=0.1)
GRANTED = (5, 9, 13, 17)
UNGRANTED = (20, 24)
R_FLIP, R_BOGUS = 3, 4


def signature_schedule(n):
    """The founder grants meta 2's permit to four members (round 0);
    from round 1 they draft double-signed records with each other as
    counterparties, and two ungranted members draft too (refused at
    create until the founder's round-3 flip to public has reached them);
    a peer pushes a double-signed record whose countersigner is a
    tracker (round 4); every 8th peer sends a direct record (rounds
    2-8)."""
    idx = np.arange(n, dtype=np.uint32)
    zero = np.zeros(n, np.uint32)
    f = SIG_CFG.founder

    def who(*ids):
        m = np.zeros(n, bool)
        m[list(ids)] = True
        return m
    out = [profiling.Create(0, META_AUTHORIZE, who(f),
                            np.full(n, g, np.uint32),
                            np.full(n, perm_bit(DBL, "permit"), np.uint32))
           for g in GRANTED]
    drafters = GRANTED + UNGRANTED
    for r in range(1, 18):
        cp = np.full(n, -1, np.int32)
        for k, a in enumerate(drafters):
            cp[a] = GRANTED[(k + r) % len(GRANTED)]
        cp[GRANTED[r % 4]] = GRANTED[r % 4]          # itself: refused
        out.append(profiling.SigRequest(r, DBL, who(*drafters), cp,
                                        idx + np.uint32(100 * r)))
    out.append(profiling.Create(R_FLIP, META_DYNAMIC, who(f),
                                np.full(n, DBL, np.uint32), zero))
    out.append(profiling.Plant(R_BOGUS, who(30), np.full(n, 7, np.uint32),
                               DBL, idx + np.uint32(1 << 31)))
    out += [profiling.Create(r, DIRECT, idx % 8 == 3, idx + 50, zero)
            for r in range(2, 9)]
    out += [profiling.Create(r, 0, idx % 8 == 5, idx + 70, zero)
            for r in (0, 4)]
    return sorted(out, key=lambda c: c.round)


def test_signature_exchange_and_direct_equal_jax():
    """(b): drafts complete (both signers' permits, then the flip),
    decline and expire, a bogus countersigner is dropped everywhere,
    direct records are received and stored nowhere -- every leaf after
    every event and round."""
    n = SIG_CFG.n_peers
    jc, js, ps, diffs = run_events(SIG_CFG, 20, signature_schedule(n))
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    same_snapshot(ps, SIG_CFG, js, jc)
    tot = totals(ps, "sig_signed", "sig_done", "sig_expired", "msgs_direct")
    assert all(v > 0 for v in tot.values()), tot
    a = state_to_numpy(ps)
    dbl = a["store_meta"] == DBL
    assert dbl.any()
    # Every stored double-signed record names another member as its
    # countersigner; the planted one (countersigner a tracker) is nowhere;
    # an ungranted member's draft completed and spread after the flip.
    assert (a["store_aux"][dbl] != a["store_member"][dbl]).all()
    assert (a["store_aux"][dbl] >= SIG_CFG.n_trackers).all()
    assert not (dbl & (a["store_member"] == 30)).any()
    assert (dbl & np.isin(a["store_member"], UNGRANTED)).any()
    assert not (a["store_meta"] == DIRECT).any()


# ---- (c) the byte-diet store with a direct meta ---------------------------------

DIET_DIRECT = profiling.slice_config(128).replace(
    n_trackers=2, k_candidates=8, msg_capacity=32, bloom_capacity=16,
    request_inbox=4, tracker_inbox=8, response_budget=4, n_meta=2,
    direct_meta_mask=0b10, churn_rate=0.02, packet_loss=0.05,
    store=StoreConfig(staging=8, compact_every=4, aux_bits=16, cohorts=4,
                      cand_bits=16))


def test_diet_direct_meta_equal_jax():
    """(c): direct records (meta 1) on the staggered byte-diet store are
    received and counted, and stored nowhere -- not in a ring, not in a
    staging buffer -- every leaf after every event and round."""
    n = DIET_DIRECT.n_peers
    idx = np.arange(n, dtype=np.uint32)
    zero = np.zeros(n, np.uint32)
    events = [profiling.Create(r, meta, idx % 16 == 3 + meta, idx + 10 * r,
                               zero)
              for r in (0, 2, 4, 7) for meta in (0, 1)]
    jc, js, ps, diffs = run_events(DIET_DIRECT, 12, events)
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    same_snapshot(ps, DIET_DIRECT, js, jc)
    tot = totals(ps, "msgs_direct", "msgs_stored")
    assert all(v > 0 for v in tot.values()), tot
    a = state_to_numpy(ps)
    assert (a["store_meta"] == 0).any()
    assert not (a["store_meta"] == 1).any() and not (a["sta_meta"] == 1).any()
    # The author's create stored nothing either, but pushed it.
    assert int(a["stats.accepted_by_meta"][:, 1].sum()) > 0


# ---- the entry points' refusals --------------------------------------------------

def test_signature_request_refusals_equal_jax():
    """``create_signature_request`` refuses a draft with no side effect
    (self, a tracker or an out-of-range counterparty, one already in
    flight, a protected meta without the permit) and takes the rest, as
    the JAX package does; a meta that is not double-signed raises in
    both, and ``create_messages`` refuses a double-signed meta in both."""
    cfg = SIG_CFG
    n, f = cfg.n_peers, cfg.founder
    jc = to_jax(cfg)
    js = ref(jstate.init_state, jc, jax.random.PRNGKey(2))
    ps = init_state(cfg, 2, device="cpu")
    authors = np.isin(np.arange(n), (f, 5, 6, 7, 8))
    cps = [(5, 9), (6, 6), (7, 0), (8, n + 3), (f, 11)]
    for step, pairs in enumerate((cps, [(5, 12), (f, 9)])):
        cp = np.full(n, -1, np.int32)
        for a, b in pairs:
            cp[a] = b
        ev = profiling.SigRequest(0, DBL, authors, cp,
                                  np.arange(n, dtype=np.uint32) + 40)
        js = jax_event(js, jc, ev)
        ps = profiling.run_creates(ps, cfg, [ev], 0)
        d = first_difference(state_to_numpy(ps), state_to_numpy(js))
        assert d is None, (step, d)
    # Only the founder's first draft stands: peer 5 holds no permit for
    # the protected meta, 6-8 name themselves, a tracker or no peer, and
    # the founder's second draft finds one in flight.
    got = state_to_numpy(ps)
    assert got["sig_target"][f] == 11 and got["sig_payload"][f] == f + 40
    assert (np.delete(got["sig_target"], f) == -1).all()
    for fn, args in ((create_signature_request,
                      (ps, cfg, torch.ones(n, dtype=torch.bool), 0,
                       torch.zeros(n, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int64))),
                     (engine.create_messages,
                      (ps, cfg, torch.ones(n, dtype=torch.bool), DBL,
                       torch.zeros(n, dtype=torch.int64)))):
        with pytest.raises(ValueError, match="(?i)double"):
            fn(*args)
    with pytest.raises(ValueError, match="double"):
        jeng.create_signature_request(js, jc, jnp.ones(n, bool), 0,
                                      jnp.zeros(n, jnp.int32),
                                      jnp.zeros(n, jnp.uint32))
    with pytest.raises(ValueError, match="DoubleMember"):
        jeng.create_messages(js, jc, jnp.ones(n, bool), DBL,
                             jnp.zeros(n, jnp.uint32))

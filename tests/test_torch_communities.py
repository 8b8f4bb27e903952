"""Several communities, unload and load, held bit for bit against the JAX
package (tolerance 0 on every PeerState leaf and counter after every event
and every round).

Three blocks of different sizes share the row axis (trackers 1 + 1 + 2
first, then 40, 30 and 54 members), as ``tests/test_multicommunity.py``
lays them out but wider, with the Timeline, a protected meta, the delay
pen with proof requests and a double-signed meta, under 3% churn and 10%
loss: each block's founder (its first member row) grants its next row,
that row posts on the protected meta, members post in every block, a
signature request crosses a block and one stays inside, a set of members
unloads and half of it loads again.  Then ``seed_overlay``'s draws, the
block layout at config #5's 1M rows, ``coverage_by_community``, the
cross-block refusals of ``create_messages`` and
``create_signature_request``, and ``tests/test_autoload.py``'s cases of
unload and load with ``auto_load`` on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispersy_tpu import engine as jeng
from dispersy_tpu import state as jstate

from dispersy_tpu_torch import (coverage_by_community, create_messages,
                                create_signature_request, engine, init_state,
                                load_members, profiling, unload_members)
from dispersy_tpu_torch.bridge import first_difference, state_to_numpy
from dispersy_tpu_torch.config import (EMPTY_U32, META_AUTHORIZE,
                                       META_DESTROY, CommunityConfig,
                                       perm_bit)
from dispersy_tpu_torch.state import INSTANCE_MEMORY_FIELDS
from test_torch_chaos import to_jax
from test_torch_ops import ref, release_xla_executables  # noqa: F401

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

DBL = 3
CFG = CommunityConfig(
    n_peers=128, n_trackers=4, communities=((40, 1), (30, 1), (54, 2)),
    msg_capacity=32, bloom_capacity=16, k_candidates=8, request_inbox=4,
    tracker_inbox=8, response_budget=4, n_meta=4, timeline_enabled=True,
    protected_meta_mask=0b10, k_authorized=8, delay_inbox=2,
    proof_requests=True, double_meta_mask=1 << DBL, churn_rate=0.03,
    packet_loss=0.1, auto_load=False)
ROUNDS = 20


def founders(cfg):
    return sorted({int(b) for b in cfg.layout()[3]})


def rows_mask(cfg, rows):
    m = np.zeros(cfg.n_peers, bool)
    m[list(rows)] = True
    return m


class Ev:
    """One call on both packages: ``kind`` is "create", "sig", "unload"
    or "load"."""

    def __init__(self, rnd, kind, mask, meta=0, payload=0, aux=0):
        self.round, self.kind, self.mask, self.meta = rnd, kind, mask, meta
        n = mask.shape[0]
        self.payload = np.broadcast_to(np.asarray(payload, np.int64),
                                       (n,)).copy()
        self.aux = np.broadcast_to(np.asarray(aux, np.int64), (n,)).copy()


def apply_port(ps, pc, ev):
    m = torch.from_numpy(ev.mask)
    if ev.kind == "create":
        return create_messages(ps, pc, m, ev.meta,
                               torch.from_numpy(ev.payload),
                               torch.from_numpy(ev.aux))
    if ev.kind == "sig":
        return create_signature_request(ps, pc, m, ev.meta,
                                        torch.from_numpy(ev.aux),
                                        torch.from_numpy(ev.payload))
    if ev.kind == "unload":
        return unload_members(ps, pc, m)
    return load_members(ps, m)


def apply_jax(js, jc, ev):
    m = jnp.asarray(ev.mask)
    if ev.kind == "create":
        return jeng.create_messages_jit(js, jc, m, ev.meta,
                                        jnp.asarray(ev.payload, jnp.uint32),
                                        jnp.asarray(ev.aux, jnp.uint32))
    if ev.kind == "sig":
        return jeng.create_signature_request_jit(
            js, jc, m, ev.meta, jnp.asarray(ev.aux, jnp.int32),
            jnp.asarray(ev.payload, jnp.uint32))
    if ev.kind == "unload":
        return jeng.unload_members_jit(js, jc, m)
    return jeng.load_members_jit(js, m)


def run_both(pc, rounds, events, seed=3, degree=6, kept=None):
    """Both packages from one seeded overlay; each round's events before
    its step.  Returns (JAX config, JAX state, port state, the first
    leaf difference after each event and each round); ``kept`` (a dict)
    takes the port state after each round."""
    jc = to_jax(pc)
    assert repr(jc) == repr(pc)
    js = ref(lambda key: jeng.seed_overlay(jstate.init_state(jc, key), jc,
                                           degree=degree),
             jax.random.PRNGKey(seed))
    ps = engine.seed_overlay(init_state(pc, seed, device="cpu"), pc, degree)
    diffs = [("seed_overlay", first_difference(state_to_numpy(ps),
                                               state_to_numpy(js)))]
    for rnd in range(rounds):
        for i, ev in enumerate(e for e in events if e.round == rnd):
            js, ps = apply_jax(js, jc, ev), apply_port(ps, pc, ev)
            diffs.append((f"round {rnd} event {i} ({ev.kind})",
                          first_difference(state_to_numpy(ps),
                                           state_to_numpy(js))))
        js, ps = jeng.step(js, jc), engine.step(ps, pc)
        diffs.append((f"round {rnd}", first_difference(
            state_to_numpy(ps), state_to_numpy(js))))
        if kept is not None:
            kept[rnd] = ps
    return jc, js, ps, diffs


def schedule(cfg):
    """The blocks' events: grants, protected and public posts, a refused
    protected post, signature requests inside and across blocks, an
    unload of four members a block (and a tracker, which stays), a
    create by an unloaded author, a load of half of them."""
    n, f = cfg.n_peers, founders(cfg)
    idx = np.arange(n)
    fmask = rows_mask(cfg, f)
    grantee = np.where(fmask, idx + 1, 0)
    cp = np.full(n, -1)
    cp[[x + 4 for x in f]] = [x + 5 for x in f]
    cp[f[0] + 6] = f[1] + 2                    # across blocks: refused
    dark = [x + k for x in f for k in (7, 8, 9, 10)]
    return [
        Ev(0, "create", fmask, META_AUTHORIZE, grantee,
           perm_bit(1, "permit")),
        Ev(1, "create", (idx >= cfg.n_trackers) & (idx % 8 == 3), 0, idx),
        Ev(3, "create", rows_mask(cfg, [x + 1 for x in f]), 1, idx + 500),
        Ev(3, "create", rows_mask(cfg, [x + 3 for x in f]), 1, idx + 900),
        Ev(4, "sig", rows_mask(cfg, [x + 4 for x in f] + [f[0] + 6]), DBL,
           idx + 7000, cp),
        Ev(6, "unload", rows_mask(cfg, dark + [0]), 0),
        Ev(7, "create", rows_mask(cfg, dark[:2] + [f[2] + 2]), 0,
           idx + 300),
        Ev(12, "load", rows_mask(cfg, dark[::2])),
    ]


@pytest.fixture(scope="module")
def blocks_run():
    return run_both(CFG, ROUNDS, schedule(CFG))


def test_three_blocks_equal_jax(blocks_run):
    """Every leaf after every event and every round, over 20 rounds; and
    the schedule did what it says: the grants and protected posts
    spread, a request completed, the pen parked, rows stayed dark."""
    _, _, ps, diffs = blocks_run
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    tot = {k: int(getattr(ps.stats, k).view(torch.int32).to(
        torch.int64).sum()) for k in ("sig_done", "msgs_delayed",
                                      "msgs_rejected", "msgs_stored")}
    assert all(tot.values()), tot
    dark = [x + k for x in founders(CFG) for k in (7, 8, 9, 10)]
    # Loaded again: by the load; dark (auto_load off): some of the rest,
    # which churn did not rebirth.
    assert bool(ps.loaded[dark[::2]].all())
    assert not bool(ps.loaded[dark[1::2]].all())
    assert bool(ps.loaded[0])


def test_records_and_candidates_stay_in_their_block(blocks_run):
    """No stored record, no candidate and no grant crosses a block."""
    _, _, ps, _ = blocks_run
    comm = CFG.layout()[0]
    d = state_to_numpy(ps)
    mem = d["store_member"].astype(np.int64)
    live = mem != EMPTY_U32
    rows = np.broadcast_to(np.arange(CFG.n_peers)[:, None], mem.shape)
    assert live.sum() > 0
    assert (comm[mem[live]] == comm[rows[live]]).all()
    cand = d["cand_peer"]
    rows = np.broadcast_to(np.arange(CFG.n_peers)[:, None], cand.shape)
    ok = cand >= 0
    assert (comm[cand[ok]] == comm[rows[ok]]).all()
    am = d["auth_member"].astype(np.int64)
    ok = am != EMPTY_U32
    rows = np.broadcast_to(np.arange(CFG.n_peers)[:, None], am.shape)
    assert ok.any() and (comm[am[ok]] == comm[rows[ok]]).all()


def test_coverage_by_community_equal(blocks_run):
    """``coverage_by_community`` bit-equal to JAX's for each block's
    protected post and for a public post: each record covers its own
    block and no other."""
    jc, js, ps, _ = blocks_run
    f = founders(CFG)
    d = state_to_numpy(ps)
    comm = CFG.layout()[0]
    recs = []
    for c, x in enumerate(f):
        # The grantee's protected post, and the block's first public
        # post: their gt read from the stores that hold them (churn may
        # have wiped a record everywhere).
        for author, meta, pay in ((x + 1, 1, x + 1 + 500),
                                  (x + (3 - x) % 8, 0, None)):
            pay = author if pay is None else pay
            hit = ((d["store_member"] == author) & (d["store_meta"] == meta)
                   & (d["store_payload"] == pay))
            if hit.any():
                recs.append((comm[author], (author, int(d["store_gt"][hit][0]),
                                            meta, pay)))
    assert len(recs) >= 4, recs
    for c, rec in recs:
        got = coverage_by_community(ps, CFG, *rec).numpy()
        want = np.asarray(jeng.coverage_by_community(js, jc, *rec))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert got[c] > 0 and (np.delete(got, c) == 0).all(), (rec, got)


def test_seed_overlay_blocks_equal_jax():
    """``seed_overlay`` draws inside each row's block, equal to JAX's,
    with a two-member block (every draw wraps) and full degree."""
    pc = CommunityConfig(n_peers=24, n_trackers=3,
                         communities=((2, 1), (11, 1), (8, 1)),
                         k_candidates=8, msg_capacity=8, bloom_capacity=8,
                         request_inbox=2, tracker_inbox=4,
                         response_budget=2)
    jc = to_jax(pc)
    for seed, degree in ((0, 8), (11, 3)):
        js = jeng.seed_overlay(jstate.init_state(jc, jax.random.PRNGKey(
            seed)), jc, degree=degree)
        ps = engine.seed_overlay(init_state(pc, seed, device="cpu"), pc,
                                 degree)
        assert first_difference(state_to_numpy(ps),
                                state_to_numpy(js)) is None
    with pytest.raises(ValueError, match="two members"):
        engine.seed_overlay(init_state(pc.replace(
            n_peers=23, communities=((1, 1), (11, 1), (8, 1))), 0,
            device="cpu"), pc.replace(
            n_peers=23, communities=((1, 1), (11, 1), (8, 1))), 4)


def test_layout_cols_block_boundaries():
    """``_layout_cols`` equals ``CommunityConfig.layout()`` on the first
    and last row of every block at config #5's 1M rows (row 8 starts
    block 0's members), and on every row of the three-block config."""
    for cfg in (profiling.communities_config(1_000_000), CFG):
        comm, bb, bc, mb, mc = cfg.layout()
        got = [c.numpy() for c in engine._layout_cols(cfg, "cpu")]
        if cfg is CFG:
            for g, w in zip(got, (bb, bc, mb, mc)):
                np.testing.assert_array_equal(g, w)
            continue
        edges = sorted({0, cfg.n_trackers - 1, cfg.n_peers - 1}
                       | {int(b) for b in mb}
                       | {int(b) - 1 for b in mb[cfg.n_trackers:]}
                       | {int(b) + int(c) - 1 for b, c in zip(mb, mc)})
        assert cfg.n_trackers == 8 and mb[8] == 8 and comm[8] == 0
        for g, w in zip(got, (bb, bc, mb, mc)):
            np.testing.assert_array_equal(g[edges], w[edges])
        f = engine._founder_col(cfg, "cpu")
        assert f.dtype == torch.uint32
        np.testing.assert_array_equal(
            f.view(torch.int32).numpy()[edges], mb[edges])


def test_cross_block_refusals_equal_jax():
    """A destroy by a block's founder is taken and by its second member
    refused; a signature request whose counterparty lies in another
    block (or is a tracker) is refused, inside the block taken -- and
    both packages agree on every leaf."""
    pc = CFG.replace(churn_rate=0.0, packet_loss=0.0)
    f = founders(pc)
    n = pc.n_peers
    idx = np.arange(n)
    cp = np.full(n, -1)
    cp[f[0] + 1] = f[1] + 1          # another block
    cp[f[1] + 1] = f[1] + 2          # inside
    cp[f[2] + 1] = 2                 # block 2's own tracker
    cp[f[2] + 3] = f[2] + 4          # inside
    evs = [Ev(0, "create", rows_mask(pc, [f[1], f[2] + 1]), META_DESTROY),
           Ev(0, "sig", rows_mask(pc, [x + 1 for x in f] + [f[2] + 3]),
              DBL, idx, cp)]
    _, js, ps, diffs = run_both(pc, 1, evs)
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    ps = engine.seed_overlay(init_state(pc, 3, device="cpu"), pc, 6)
    before = ps.global_time.clone()
    ps = apply_port(ps, pc, evs[0])
    moved = (ps.global_time != before).nonzero().flatten().tolist()
    assert moved == [f[1]]
    ps = apply_port(ps, pc, evs[1])
    sent = (ps.sig_target >= 0).nonzero().flatten().tolist()
    assert sent == [f[1] + 1, f[2] + 3]


# ---- unload and load (tests/test_autoload.py's cases) -------------------

AL = CommunityConfig(n_peers=40, n_trackers=2, communities=((20, 1),
                                                            (18, 1)),
                     msg_capacity=32, bloom_capacity=16, k_candidates=8,
                     request_inbox=4, tracker_inbox=8, response_budget=4)
U = 9


@pytest.mark.parametrize("auto_load", [True, False])
def test_unload_load_equal_jax(auto_load):
    """With ``auto_load`` on the unloaded peer loads again from the
    traffic that reaches it; off, it stays dark (its store frozen, a
    record made meanwhile missing, its create a no-op) until the
    explicit load, after which it catches up.  A tracker in the mask is
    never unloaded; the instance memory is empty after the unload."""
    pc = AL.replace(auto_load=auto_load)
    n = pc.n_peers
    idx = np.arange(n)
    evs = [Ev(4, "unload", rows_mask(pc, [0, U, 30])),
           Ev(5, "create", rows_mask(pc, [5, U]), 1, 77),
           Ev(14, "load", rows_mask(pc, [U, 30]))]
    kept = {}
    jc, js, ps, diffs = run_both(pc, 28, evs, seed=0, degree=4, kept=kept)
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    # The unload itself, on the port alone: trackers stay, memory empty.
    st = engine.seed_overlay(init_state(pc, 0, device="cpu"), pc, 4)
    st = unload_members(st, pc, torch.from_numpy(rows_mask(pc, [0, U])))
    assert bool(st.loaded[0]) and not bool(st.loaded[U])
    fresh = init_state(pc, 0, device="cpu")
    for name, _ in INSTANCE_MEMORY_FIELDS:
        got, want = getattr(st, name), getattr(fresh, name)
        if got.dim() and got.shape[0] == n:
            assert torch.equal(got[U].view(torch.uint8),
                               want[U].view(torch.uint8)), name
    def holds(state):
        d = state_to_numpy(state)
        return ((d["store_member"] == 5) & (d["store_payload"] == 77)).any(1)
    end, dark = holds(ps), holds(kept[13])
    assert bool(ps.loaded[U]) and end[U]
    assert not end[idx >= 22].any()          # block 1 never sees it
    # Before the explicit load (round 14): with auto_load the traffic
    # loaded U again and it took the round-5 record in; without, U stayed
    # dark and missed it while the rest of its block took it.
    assert bool(kept[13].loaded[U]) == auto_load
    assert dark[U] == auto_load and dark[(idx >= 3) & (idx < 22)].sum() > 10


def test_unloaded_author_create_is_noop():
    pc = AL.replace(auto_load=False)
    st = engine.seed_overlay(init_state(pc, 0, device="cpu"), pc, 4)
    st = unload_members(st, pc, torch.from_numpy(rows_mask(pc, [U])))
    before = state_to_numpy(st)
    st = create_messages(st, pc, torch.from_numpy(rows_mask(pc, [U])), 1,
                         torch.zeros(pc.n_peers, dtype=torch.int64))
    assert first_difference(state_to_numpy(st), before) is None


def test_signature_request_autoloads_counterparty():
    """A signature request reaching an unloaded counterparty loads it,
    equal to JAX's on every leaf."""
    pc = AL.replace(double_meta_mask=0b100, sig_inbox=2,
                    walker_enabled=False, sync_enabled=False,
                    forward_fanout=0)
    n = pc.n_peers
    evs = [Ev(0, "unload", rows_mask(pc, [U])),
           Ev(0, "sig", rows_mask(pc, [5]), 2, 9, np.full(n, U))]
    _, _, ps, diffs = run_both(pc, 2, evs, seed=0, degree=4)
    bad = [(w, d) for w, d in diffs if d is not None]
    assert not bad, bad[0]
    assert bool(ps.loaded[U])

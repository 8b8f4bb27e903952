#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions; builds the CUDA kernels from ``dispersy_tpu_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, in parallel);
2. kernels: every kernel of the five paths (K1-K12) on random inputs
   made with a numpy seed at the shapes the 1M-peer rounds give it -- the
   legacy ring's shapes (K1 at each of its call shapes, and the delivery
   core's corners for K1, K1 with classes and K12; K3 at the intake
   merge and the one-record insert, and K3's corners: rings out of
   order, ties, empty and overflowing rows, B = 1, 8, 24, M + B = 256,
   history groups across ring and batch, u16 aux), the byte-diet round's
   (u16 aux columns, per-row Bloom salts, the cohort block, the staging
   buffer), the permissioned round's (the [N, 8] grant tables, the store
   replays in each K9 mode at the intake's and the retro pass's shapes,
   and K9's corners: Q = 1, 24, 48, nothing or everything selected,
   times at and above 2^31, several rows of one key; store_remove, K3
   with a LastSync history), then the hardened round's
   (the store probes in each K11 mode, with planted hits), then the
   chaos round's (K12 on the capped push blast with admission classes,
   on the exact request channel with receipts, where it must also equal
   K1, and on the exact puncture channels; K1 with classes on the
   unsharded push blast) -- held bit
   for bit against its plain PyTorch version on the card, and timed with
   CUDA events beside the plain version, the bytes bound and, where one
   PyTorch call does the same work, that call (for K1 and K12
   ``torch.sort`` of the packed destination key, for K3 of the packed
   (gt, member) key);
3. parity: 4096-peer runs on the card through the kernels and on the CPU
   through the plain versions, equal on every state leaf after every
   round: the legacy ring for 20 rounds, the byte-diet
   ``bench_config(4096)`` for 24 rounds (two compaction windows), and the
   permissioned community for 22 rounds of
   ``profiling.permissioned_schedule`` (the destroy included), and the
   hardened community for 20 rounds of ``profiling.hardened_schedule``
   (its convictions, gossip and stored identities checked after), and
   the chaos round sharded (``profiling.chaos_config(4096, 8, 64)``,
   which must shed at the cross-shard cap) and unsharded (whose
   overload plane must shed), 20 rounds each;
4. main paths through the public entry points -- init_state,
   seed_overlay(8), the creates, warm-up and timed rounds -- each with
   every kernel's launch count read after it: the byte-diet round at
   ``bench_config(1 << 20)`` exactly (one record by every 64th peer;
   3 + 24 rounds, so every cohort compacts twice; ms per round overall,
   quiet and sync), the legacy ring at the same shape (3 + 5 rounds), and
   the permissioned round of ``permissioned_config(1 << 20)`` (the
   schedule without the destroy; 3 + 5 rounds, the founder's revoke and
   its retro pass among them), and the hardened round of
   ``hardened_config(1 << 20)`` (3 + 5 rounds: identities over rounds
   0-3, the sequence chain, the round-4 equivocations), and the chaos
   round of ``chaos_config(1 << 20)`` sharded (3 + 5 rounds; the cap
   must shed in the timed rounds) and unsharded (3 + 5 rounds, K1 with
   admission classes), each printing its shed, recovery and health
   totals and the count of store rows that break K3's merge-path
   invariant (``ring_unordered_rows``, expected 0).

The second-to-last lines are the card line and the kernels JSON line; the
last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX or of the JAX package, and needs a CUDA card: without one
it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (on-chip guide)
SCALAR_OPS_PER_S = 67e12       # H100 float32 outside the tensor cores
N_PEERS = 1 << 20              # the full width: bench_config(1 << 20)
PARITY_PEERS, PARITY_ROUNDS, DIET_PARITY_ROUNDS = 4096, 20, 24
PERM_PARITY_ROUNDS = 22        # the whole schedule, the destroy included
HARD_PARITY_ROUNDS = 20
CHAOS_PARITY_ROUNDS, CHAOS_PARITY_BUDGET = 20, 64
CHAOS_BUDGET = 4096            # the 1M main path's cross_shard_budget
P_PUSH = 0.05                  # valid push edges in the chaos kernel rows
WARMUP, ROUNDS = 3, 5          # the legacy and permissioned main paths
DIET_WARMUP, DIET_ROUNDS = 3, 24   # the diet main path: two windows
REPS = 20                      # timed launches per kernel (median)
SEED = 0
# The kernels each main path must launch (kernels.LAUNCHES keys).
LEGACY_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert",
               "rank_compact_many", "intake_checks")
DIET_PATH = ("deliver", "bloom_build", "bloom_query", "digest_update",
             "store_insert", "rank_compact_many", "store_stage",
             "dup_earlier")
PERM_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert_history",
             "rank_compact_many", "intake_checks", "timeline_check",
             "timeline_check_grant", "store_match_flip",
             "store_match_undo_marked", "store_match_meta_of",
             "store_match_undo_hits", "store_remove")
HARD_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert",
             "rank_compact_many", "intake_checks", "store_probe_conflict",
             "store_probe_identity", "store_probe_seq_max")
CHAOS_PATH = ("deliver", "deliver_ragged", "bloom_build", "bloom_query",
              "digest_update", "store_insert", "rank_compact_many",
              "store_stage", "dup_earlier")
CHAOS_FLAT_PATH = ("deliver", "deliver_cls", "bloom_build", "bloom_query",
                   "digest_update", "store_insert", "rank_compact_many",
                   "store_stage", "dup_earlier")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired tensors (integers and
    bools compared as int64); a shape or dtype mismatch fails."""
    import torch
    from dispersy_tpu_torch.u32 import wide
    worst = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype {g.dtype}{list(g.shape)} vs "
                 f"{w.dtype}{list(w.shape)}")
        if g.dtype in (torch.uint32, torch.uint16):
            gi, wi = wide(g), wide(w)
        else:
            gi, wi = g.long(), w.long()
        diff = (gi - wi).abs()
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
    return worst


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---- phase 2: the kernels against their plain versions ---------------------

def inputs(cfg, seed: int):
    """Random inputs made with a numpy seed, on the card
    (``profiling.Draw``), carrying the path's 1M-peer config ``cfg``."""
    from dispersy_tpu_torch.profiling import Draw
    x = Draw(seed, "cuda")
    x.cfg = cfg
    return x


def timed_entry(name, route, source, replaces, got, want, kernel_fn,
                plain_fn, bytes_moved, reps, ops=0, library_fn=None,
                kernel=None) -> dict:
    """Hold a kernel's outputs against its plain version's, then time
    kernel, plain version and library call; one kernels-JSON row.
    ``kernel`` is the row's ``kernels.LAUNCHES`` key (default ``name``)."""
    from dispersy_tpu_torch.profiling import cuda_ms
    err = max_abs_err(got, want)
    if err != 0:
        fail(f"kernel {name} disagrees with its plain version "
             f"(max abs err {err})")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, reps)
    lib_ms = cuda_ms(library_fn, reps) if library_fn else None
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "_kernel": kernel or name}
    print(f"kernel {name}: mismatches 0, kernel_ms {ms:.4f}, plain_ms "
          f"{plain_ms:.4f}, bound_ms {row['bound_ms']:.4f} "
          f"({row['bound_by']}), library_ms {lib_ms}", flush=True)
    return row


def k1_row(x: Draw, name, dst, valid, cols, n_dst, q, got, want, reps,
           cls=None, kernel="deliver") -> dict:
    """A K1 kernels-JSON row: ``got`` held against ``want``, then K1, its
    plain version and ``torch.sort`` of the packed (destination, class,
    position) key timed on the same edges.  The bound counts dst and
    valid (and the class) of every edge, the row of every landed edge,
    the [N, Q] inboxes and their mask, the drops and the receipts."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    e = dst.shape[0]
    kept = int((got[-1] >= 0).sum())
    row_b = sum(c[:1].numel() * c.element_size() for c in cols)
    moved = ((5 if cls is None else 6) * e + kept * row_b
             + n_dst * q * (row_b + 1) + 4 * n_dst + 4 * e)
    ok = valid & (dst >= 0) & (dst < n_dst)
    key = torch.where(ok, dst.long(), n_dst) * 256
    if cls is not None:
        key = key + cls.long()
    key = key * e + torch.arange(e, device=x.dev)
    return timed_entry(
        name, "cuda", "dispersy_tpu_torch/csrc/deliver.cu",
        "dispersy_tpu/ops/inbox.py:79", got, want,
        lambda: kernels.deliver(dst, cols, valid, n_dst, q, cls),
        lambda: inbox.deliver_plain(dst, cols, valid, n_dst, q, cls), moved,
        reps, library_fn=lambda: torch.sort(key), kernel=kernel)


def check_deliver(x: Draw, reps: int) -> list:
    """K1 at each of its call shapes in the legacy round, each timed: the
    push blast (E = N·F·C, five columns, Q = push_inbox), the request
    (seven columns with the [E, W] bloom), the tracker call (N = T, Q =
    tracker_inbox: groups far above 32, the longest runs) and the
    puncture hops (E = N·R, one column, Q = request_inbox)."""
    torch = x.torch
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers

    def case(name, e, n_dst, q, cols, p, lo=-1):
        dst, valid, got, want = deliver_case(x, e, n_dst, q, cols, p, lo)
        return k1_row(x, name, dst, valid, cols, n_dst, q, got, want, reps)

    e = n * cfg.forward_buffer * cfg.forward_fanout
    rows = [case("deliver", e, n, cfg.push_inbox,
                 [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u32(e)],
                 0.9)]
    req = [narrow(torch.arange(n, device=x.dev))] + [
        x.u32(n) for _ in range(5)] + [x.u32(n, cfg.bloom_words)]
    rows.append(case("deliver_request_bloom", n, n, cfg.request_inbox, req,
                     0.9))
    trk = [narrow(torch.arange(n, device=x.dev)), x.u32(n)]
    rows.append(case("deliver_tracker", n, cfg.n_trackers, cfg.tracker_inbox,
                     trk, 0.08, lo=0))
    r = cfg.request_inbox
    rows.append(case("deliver_puncture", n * r, n, r,
                     [x.u32(n * r, hi=n)], 0.7))
    return rows


def deliver_case(x: Draw, e, n_dst, q, cols, p_valid, lo=-1):
    """K1 and its plain version on one random edge list: ``(dst, valid,
    kernel outputs, plain outputs)``."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    dst = corner_dst(x, e, n_dst, lo=lo)
    valid = x.flags(p_valid, e)
    inb, inb_valid, dropped, slot = kernels.deliver(dst, cols, valid, n_dst,
                                                    q)
    want = inbox.deliver_plain(dst, cols, valid, n_dst, q)
    return (dst, valid, [*inb, inb_valid, dropped, slot],
            [*want.inbox, *want[1:]])


def corner_dst(x: Draw, e, n_dst, groups=(), lo=-1):
    """i32[e] destinations in [lo, n_dst] (the ends parked), destination i
    holding exactly ``groups[i]`` edges at random positions."""
    np = x.np
    k = len(groups)
    rest = x.rs.integers(k if k else lo, n_dst + 1, size=e - sum(groups))
    dst = np.concatenate([np.full(g, i) for i, g in enumerate(groups)]
                         + [rest]).astype(np.int32)
    if k:
        dst = x.rs.permutation(dst)
    return x.torch.from_numpy(dst).to(x.dev)


def check_deliver_corners(x: Draw, reps: int) -> list:
    """The radix core's corners, untimed, each held bit for bit against
    the plain version on the card: K1 with and without admission
    classes, K12 exact with receipts and capped (budget 64) with classes
    and without, over 1,000,008 destinations (not a multiple of 1024; 8
    shards divide it) -- groups of exactly 32 and 33 edges, one hot
    destination above 2048 edges, no edges, every edge invalid, Q = 1,
    all classes equal, all 256 classes distinct in one group.  The
    columns are u32, u8, u16 and bool (packed into one row per edge) and
    [E, 3] and [E, 5] u32 (gathered straight)."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    n = 8 * 125_001
    cases = [  # (name, E, Q, p_valid, exact groups, classes)
        ("groups_32_33", 200_000, 32, 1.0, (32, 33), "random"),
        ("hot_2048", 1 << 20, 16, 0.9, (100_000,), "random"),
        ("no_edges", 0, 4, 0.5, (), "random"),
        ("all_invalid", 1 << 20, 4, 0.0, (), "random"),
        ("q1", 1 << 20, 1, 0.9, (), "random"),
        ("classes_equal", 1 << 20, 4, 0.9, (40,), "equal"),
        ("classes_distinct", 1 << 20, 4, 0.9, (256,), "distinct"),
    ]
    for name, e, q, p, groups, kind in cases:
        cols = [x.u32(e), x.u8(e), x.u16(e), x.flags(0.5, e), x.u32(e, 3),
                x.u32(e, 5)]
        cls = x.u8(e)
        if kind == "equal":
            cls = torch.full_like(cls, 7)
        dst = corner_dst(x, e, n, groups)
        if kind == "distinct":
            perm = x.rs.permutation(256).astype(x.np.uint8)
            cls[(dst == 0).nonzero().flatten()] = torch.from_numpy(perm).to(
                x.dev)
        valid = x.flags(p, e)
        for c in (None, cls):
            inb, *rest = kernels.deliver(dst, cols, valid, n, q, c)
            want = inbox.deliver_plain(dst, cols, valid, n, q, c)
            if max_abs_err([*inb, *rest], [*want.inbox, *want[1:]]):
                fail(f"K1 corner {name} (classes {c is not None}) "
                     "disagrees with its plain version")
        for budget, c, receipts in ((0, None, True), (64, cls, False),
                                    (64, None, True)):
            got, want = ragged_case(x, dst, valid, cols, n, q, 8, budget, c,
                                    receipts)
            if max_abs_err(got, want):
                fail(f"K12 corner {name} (budget {budget}, classes "
                     f"{c is not None}) disagrees with its plain version")
        print(f"deliver corner {name}: E {e}, Q {q}, K1 and K12 bit-equal",
              flush=True)
    return []


def check_bloom(x: Draw, reps: int) -> list:
    """K2: the build over the claimed slice; the query per request slot,
    on row-strided views of the [N, R, W] request inbox."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import bloom
    from dispersy_tpu_torch.u32 import narrow
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    bits, k, words = cfg.bloom_bits, cfg.bloom_hashes, cfg.bloom_words
    salt = narrow(torch.tensor(17, device=x.dev))
    h = x.u32(n, m)
    sl = x.flags(0.7, n, m)
    n_set = int(sl.sum())       # the build reads only the masked hashes
    built = kernels.bloom_build(h, sl, bits, k, salt)
    rows = [timed_entry(
        "bloom_build", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:196",
        [built], [bloom.bloom_build_plain(h, sl, bits, k, salt)],
        lambda: kernels.bloom_build(h, sl, bits, k, salt),
        lambda: bloom.bloom_build_plain(h, sl, bits, k, salt),
        nbytes(sl) + 4 * n_set + 4 * n * words, reps, ops=n_set * k * 12)]
    inbox = torch.stack([built, x.u32(n, words), built, built], dim=1)
    qh = torch.where(x.flags(0.5, n, m), h.view(torch.int32),
                     x.u32(n, m).view(torch.int32)).view(torch.uint32)
    got = [kernels.bloom_query(inbox[:, s], qh, bits, k, salt)
           for s in range(cfg.request_inbox)]
    want = [bloom.bloom_query_plain(inbox[:, s], qh, bits, k, salt)
            for s in range(cfg.request_inbox)]
    if not bool(got[0].any()) or bool(got[0].all()):
        fail("bloom_query inputs give a constant answer")
    q_words = inbox[:, 0]
    rows.append(timed_entry(
        "bloom_query", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:277", got, want,
        lambda: kernels.bloom_query(q_words, qh, bits, k, salt),
        lambda: bloom.bloom_query_plain(q_words, qh, bits, k, salt),
        4 * n * words + nbytes(qh) + n * m, reps, ops=n * m * k * 12))
    return rows


def store_inputs(x: Draw, b: int | None = None):
    """Sorted rings with a random fill and a batch of the intake width
    (sync + push; or ``b``), keys drawn from a small range so that
    duplicates against the ring and inside the batch are common
    (``profiling.store_inputs``)."""
    from dispersy_tpu_torch.profiling import store_inputs as draw
    cfg = x.cfg
    return draw(x, cfg.n_peers, cfg.msg_capacity,
                cfg.response_budget + cfg.push_inbox if b is None else b)


def k3_row(x: Draw, name, store, batch, mask, history=(), reps=REPS,
           replaces="dispersy_tpu/ops/store.py:265") -> dict:
    """A K3 kernels-JSON row: the kernel held against its plain version,
    then both timed beside ``torch.sort`` of the packed (gt, member) key
    over the [N, M + B] concatenation (the sort form's ordering step);
    the bound is ``profiling.k3_bytes``."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import k3_bytes, k3_yardstick
    want = st.store_insert_plain(store, batch, mask, history)
    want = [*want.store, want.n_inserted, want.n_dropped, want.n_evicted]
    got = list(kernels.store_insert(store, batch, mask, history))
    return timed_entry(
        name, "cuda", "dispersy_tpu_torch/csrc/store.cu", replaces, got,
        want, lambda: kernels.store_insert(store, batch, mask, history),
        lambda: st.store_insert_plain(store, batch, mask, history),
        k3_bytes(store, mask, want, history), reps,
        library_fn=k3_yardstick(store, batch, mask),
        kernel="store_insert_history" if history else "store_insert")


def check_store(x: Draw, reps: int) -> list:
    """K3 with the fused compaction at the intake merge [N, 48] + [N, 24],
    and at ``create_messages``' one-record insert [N, 48] + [N, 1] (one
    author in 64)."""
    store, batch = store_inputs(x)
    rows = [k3_row(x, "store_insert", store, batch,
                   x.flags(0.6, *batch.gt.shape), reps=reps)]
    store, batch = store_inputs(x, 1)
    rows.append(k3_row(x, "store_insert_one", store, batch,
                       x.flags(1 / 64, *batch.gt.shape), reps=reps))
    return rows


def check_store_corners(x: Draw, reps: int) -> list:
    """K3 on the inputs its two rank paths branch on, untimed, bit-equal
    to the plain version (64K rows each, with and without a history of
    k = 1 and k = 2): rings out of order (permuted, EMPTY holes in the
    middle), so the O(W^2) rank runs; (gt, member) ties ring against
    batch and inside the batch; all-EMPTY rows; full rings that
    overflow; B = 1, 8 and 24; M + B = 256 (B = 56, past one warp);
    history groups that span ring and batch; u16 aux."""
    np, torch = x.np, x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import store_inputs as draw
    from dispersy_tpu_torch.u32 import cast
    n = 1 << 16

    def sorted_ring(m, b, keys, members, fill=None):
        """Rings sorted by (gt, member) with holes last, ``fill`` live
        slots (default random), and a batch, keys from the ranges."""
        g = x.rs.integers(1, keys, size=(n, m))
        mem = x.rs.integers(0, members, size=(n, m))
        order = np.lexsort((mem, g), axis=1)
        g, mem = (np.take_along_axis(a, order, 1) for a in (g, mem))
        k = (x.rs.integers(0, m + 1, size=n) if fill is None
             else np.full(n, fill))
        live = np.arange(m)[None, :] < k[:, None]
        store, batch = draw(x, n, m, b)
        store = store._replace(
            gt=x.from_u32(np.where(live, g, 0xFFFFFFFF)),
            member=x.from_u32(np.where(live, mem, 0xFFFFFFFF)))
        return store, batch._replace(gt=x.u32(n, b, hi=keys),
                                     member=x.u32(n, b, hi=members))

    def bits_of(c):
        return c.view(torch.int32) if c.element_size() == 4 else c

    cases = {}
    store, batch = sorted_ring(48, 24, 200, 6)
    perm = torch.from_numpy(np.argsort(x.rs.random((n, 48)), 1)).to(x.dev)
    cases["unsorted"] = (st.StoreCols(*(
        torch.gather(bits_of(c), 1, perm).view(c.dtype) for c in store)),
        batch, x.flags(0.7, n, 24))
    store, batch = sorted_ring(48, 24, 200, 6)
    hole = x.flags(0.15, n, 48)
    cases["holes"] = (store._replace(gt=torch.where(
        hole, -1, store.gt.view(torch.int32)).view(torch.uint32)), batch,
        x.flags(0.7, n, 24))
    cases["ties"] = (*sorted_ring(48, 24, 4, 2), x.flags(0.8, n, 24))
    cases["all_empty"] = (*sorted_ring(48, 24, 200, 6, fill=0),
                          x.flags(0.0, n, 24))
    cases["full_overflow"] = (*sorted_ring(48, 24, 1 << 20, 1 << 20,
                                           fill=48), x.flags(1.0, n, 24))
    for b in (1, 8):
        cases[f"b{b}"] = (*sorted_ring(48, b, 12, 3), x.flags(0.8, n, b))
    cases["width256"] = (*sorted_ring(200, 56, 40, 4), x.flags(0.7, n, 56))
    store, batch = sorted_ring(48, 24, 30, 3)
    cases["u16_aux"] = (store._replace(aux=cast(store.aux, torch.uint16)),
                        batch._replace(aux=cast(batch.aux, torch.uint16)),
                        x.flags(0.7, n, 24))
    for name, (store, batch, mask) in cases.items():
        for history in ((), (1, 2, 0, 1)):
            want = st.store_insert_plain(store, batch, mask, history)
            err = max_abs_err(
                kernels.store_insert(store, batch, mask, history),
                [*want.store, want.n_inserted, want.n_dropped,
                 want.n_evicted])
            if err != 0:
                fail(f"kernel store_insert corner {name} (history "
                     f"{history}) disagrees with its plain version (max "
                     f"abs err {err})")
        print(f"kernel store_insert corner {name}: mismatches 0 (untimed, "
              "with and without a history)", flush=True)
    return []


def check_compact(x: Draw, reps: int) -> list:
    """K4 at the responder's outbox (six columns, one slot map over the
    store width, width = response_budget), timed; and at the forward
    buffer (five columns over the intake batch, width = forward_buffer).
    Its bytes: the slot map, the entries whose slot is below the width,
    and every output."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    store, batch = store_inputs(x)

    def slots(p, w, width):
        keep = x.flags(p, n, w)
        rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        return keep, torch.where(keep & (rank < width), rank,
                                 width).to(torch.int32)

    b = cfg.response_budget
    missing, slot = slots(0.3, m, b)
    cols = [(store.gt, 0xFFFFFFFF), (store.member, 0xFFFFFFFF),
            (store.meta, 0xFF), (store.payload, 0xFFFFFFFF),
            (store.aux, 0), (missing, False)]
    got = kernels.rank_compact_many(cols, slot, b)
    fb = cfg.forward_buffer
    _, fslot = slots(0.5, batch.gt.shape[1], fb)
    fcols = [(c, st.empty_of(c.dtype)) for c in batch[:5]]
    fgot = kernels.rank_compact_many(fcols, fslot, fb)
    kept = int((slot < b).sum())
    moved = (nbytes(slot) + kept * sum(c.element_size() for c, _ in cols)
             + nbytes(*got))
    return [timed_entry(
        "rank_compact_many", "cuda", "dispersy_tpu_torch/csrc/compact.cu",
        "dispersy_tpu/ops/store.py:140", got + fgot,
        st.rank_compact_many_plain(cols, slot, b)
        + st.rank_compact_many_plain(fcols, fslot, fb),
        lambda: kernels.rank_compact_many(cols, slot, b),
        lambda: st.rank_compact_many_plain(cols, slot, b), moved, reps)]


def check_intake(x: Draw, reps: int) -> list:
    """K5 on a ring and a batch of the intake width."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    store, batch = store_inputs(x)
    n, b = batch.gt.shape
    m = store.gt.shape[1]
    ok = x.flags(0.8, n, b)
    args = (store.gt, store.member, batch.member, batch.gt, ok)

    def plain():
        return (intake.in_store_plain(*args[:4]),
                intake.dup_earlier_plain(batch.member, batch.gt, ok))
    got = kernels.intake_checks(*args)
    if not bool(got[0].any()) or not bool(got[1].any()):
        fail("intake inputs never hit")
    return [timed_entry(
        "intake_checks", "triton",
        "dispersy_tpu_torch/kernels/intake_triton.py",
        "dispersy_tpu/ops/intake.py:80", got, plain(),
        lambda: kernels.intake_checks(*args), plain,
        nbytes(*args) + 2 * n * b, reps, ops=2 * n * b * (m + b))]


KERNEL_CHECKS = (check_deliver, check_deliver_corners, check_bloom,
                 check_store, check_store_corners, check_compact,
                 check_intake)

# ---- phase 2, the byte-diet round's call shapes ------------------------------

def check_diet_deliver(x: Draw, reps: int) -> list:
    """K1 on the diet's push blast, whose fifth column is the forward
    buffer's u16 aux (timed), and on the quiet round's 2-column request
    (the staggered sync round's too)."""
    torch = x.torch
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers
    e = n * cfg.forward_buffer * cfg.forward_fanout
    q = cfg.push_inbox
    cols = [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u16(e)]
    dst, valid, got, want = deliver_case(x, e, n, q, cols, 0.9)
    req = [narrow(torch.arange(n, device=x.dev)), x.u32(n)]
    _, _, rg, rw = deliver_case(x, n, n, cfg.request_inbox, req, 0.9)
    if max_abs_err(rg, rw):
        fail("K1 disagrees with its plain version on the diet request")
    return [k1_row(x, "deliver_diet_push_u16", dst, valid, cols, n, q, got,
                   want, reps)]


def check_diet_bloom(x: Draw, reps: int) -> list:
    """K6 digest_update on the landed arrivals [N, 24] with per-peer
    epoch salts; K2's query of the same items against the digest (the
    freshness test, per-row salt), its serve query of a cohort block
    [N/4, 48] against a strided view of the digest (one salt), and the
    digest rebuild over the compacted block [N/4, 48]."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import bloom
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.u32 import narrow
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    bits, k, w = cfg.bloom_bits, cfg.bloom_hashes, cfg.bloom_words
    b = cfg.response_budget + cfg.push_inbox
    coh = cfg.store.cohorts
    blk = n // coh
    dig = narrow((x.u32(n, w).view(torch.int32).long()
                  & x.u32(n, w).view(torch.int32).long()))
    ep = x.u32(n, hi=4)                          # per-peer epochs
    h = x.u32(n, b)
    landed = x.flags(0.4, n, b)
    n_set = int(landed.sum())
    got = kernels.digest_update(dig, h, landed, bits, k, ep)
    rows = [timed_entry(
        "digest_update", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:234", [got],
        [bloom.digest_update_plain(dig, h, landed, bits, k, ep)],
        lambda: kernels.digest_update(dig, h, landed, bits, k, ep),
        lambda: bloom.digest_update_plain(dig, h, landed, bits, k, ep),
        8 * n * w + nbytes(landed) + 4 * n_set + 4 * n, reps,
        ops=n_set * k * 12)]
    qh = torch.where(x.flags(0.5, n, b), h.view(torch.int32),
                     x.u32(n, b).view(torch.int32)).view(torch.uint32)
    fresh = kernels.bloom_query(got, qh, bits, k, ep)
    if not bool(fresh.any()) or bool(fresh.all()):
        fail("bloom_query (row salt) inputs give a constant answer")
    rows.append(timed_entry(
        "bloom_query_diet_fresh", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:277", [fresh],
        [bloom.bloom_query_plain(got, qh, bits, k, ep)],
        lambda: kernels.bloom_query(got, qh, bits, k, ep),
        lambda: bloom.bloom_query_plain(got, qh, bits, k, ep),
        4 * n * w + nbytes(qh) + 4 * n + n * b, reps, ops=n * b * k * 12,
        kernel="bloom_query"))
    salt = narrow(torch.tensor(0xFFFFFFFF, device=x.dev))
    dig_blk = st.cohort_take(got, 1, coh)        # row stride coh * w
    rec = x.u32(blk, m)
    rec = torch.where(x.flags(0.5, blk, m), rec.view(torch.int32),
                      qh[:blk, :1].view(torch.int32)).view(torch.uint32)
    serve = kernels.bloom_query(dig_blk, rec, bits, k, salt)
    rows.append(timed_entry(
        "bloom_query_diet_serve", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:277", [serve],
        [bloom.bloom_query_plain(dig_blk, rec, bits, k, salt)],
        lambda: kernels.bloom_query(dig_blk, rec, bits, k, salt),
        lambda: bloom.bloom_query_plain(dig_blk, rec, bits, k, salt),
        4 * blk * w + nbytes(rec) + blk * m, reps, ops=blk * m * k * 12,
        kernel="bloom_query"))
    in_sl = x.flags(0.7, blk, m)
    n_sl = int(in_sl.sum())
    rows.append(timed_entry(
        "bloom_build_diet_rebuild", "cuda", "dispersy_tpu_torch/csrc/bloom.cu",
        "dispersy_tpu/ops/bloom.py:196",
        [kernels.bloom_build(rec, in_sl, bits, k, salt)],
        [bloom.bloom_build_plain(rec, in_sl, bits, k, salt)],
        lambda: kernels.bloom_build(rec, in_sl, bits, k, salt),
        lambda: bloom.bloom_build_plain(rec, in_sl, bits, k, salt),
        nbytes(in_sl) + 4 * n_sl + 4 * blk * w, reps, ops=n_sl * k * 12,
        kernel="bloom_build"))
    return rows


def check_diet_stage(x: Draw, reps: int) -> list:
    """K7 store_stage: the [N, 24] intake batch (u32 aux, narrowed in the
    kernel) into the [N, 8] staging buffer.  Its bytes: the mask, the
    staging row, the columns of the arrivals that land, every output."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import diet_cols
    cfg, n = x.cfg, x.cfg.n_peers
    s = cfg.store.staging
    b = cfg.response_budget + cfg.push_inbox
    staging = diet_cols(x, n, s, prefix=True)
    batch = st.StoreCols(
        gt=x.u32(n, b, hi=200), member=x.u32(n, b, hi=6),
        meta=x.u8(n, b, hi=4), payload=x.u32(n, b), aux=x.u32(n, b),
        flags=x.u8(n, b, hi=2))
    mask = x.flags(0.25, n, b)
    got = list(kernels.store_stage(staging, batch, mask))
    cast_b = st.as_store_dtypes(batch, staging)
    want = st.store_stage_plain(staging, cast_b, mask)
    if not bool(want.n_dropped.any()):
        fail("store_stage inputs never overflow")
    landed = int(got[6].sum())
    slot_b = 4 * 3 + 1 + 2 + 1
    moved = (nbytes(mask) + n * s * slot_b + landed * (slot_b + 2)
             + nbytes(*got))
    return [timed_entry(
        "store_stage", "cuda", "dispersy_tpu_torch/csrc/stage.cu",
        "dispersy_tpu/ops/store.py:510", got, [*want.staging, *want[1:]],
        lambda: kernels.store_stage(staging, batch, mask),
        lambda: st.store_stage_plain(staging, cast_b, mask), moved, reps)]


def check_diet_store(x: Draw, reps: int) -> list:
    """K3 at the staggered compaction: a cohort block's [N/4, 48] ring
    and its [N/4, 8] staging buffer, u16 aux; and, untimed, the same
    merge with a LastSync history (meta 2 keeps its newest record per
    member: a diet with a LastSync meta), bit-equal to the plain version."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import diet_cols
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    blk = n // cfg.store.cohorts
    ring = diet_cols(x, blk, m, prefix=False)
    sta = diet_cols(x, blk, cfg.store.staging, prefix=True)
    mask = sta.valid
    want = st.store_insert_plain(ring, sta, mask)
    hist = (0, 0, 1)
    want_h = st.store_insert_plain(ring, sta, mask, hist)
    if not bool((want_h.n_evicted + want_h.n_dropped
                 > want.n_evicted + want.n_dropped).any()):
        fail("diet store_insert history inputs never evict")
    err = max_abs_err(kernels.store_insert(ring, sta, mask, hist),
                      [*want_h.store, want_h.n_inserted, want_h.n_dropped,
                       want_h.n_evicted])
    if err != 0:
        fail(f"kernel store_insert with a history at the diet compaction's "
             f"u16 shapes disagrees with its plain version (max abs err "
             f"{err})")
    print("kernel store_insert_history_diet_compact: mismatches 0 "
          "(untimed)", flush=True)
    return [k3_row(x, "store_insert_diet_compact", ring, sta, mask,
                   reps=reps)]


def check_diet_compact(x: Draw, reps: int) -> list:
    """K4 at the staggered serve's outbox (a cohort block's [N/4, 48]
    gathered rings to width 8, six columns with the u16 aux), timed; and
    at the forward buffer ([N, 24] to width 4, the aux at u16)."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import diet_cols
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    blk = n // cfg.store.cohorts
    ring = diet_cols(x, blk, m, prefix=False)

    def slots(p, rows, w, width):
        keep = x.flags(p, rows, w)
        rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        return keep, torch.where(keep & (rank < width), rank,
                                 width).to(torch.int32)

    b = cfg.response_budget
    missing, slot = slots(0.3, blk, m, b)
    cols = [(ring.gt, 0xFFFFFFFF), (ring.member, 0xFFFFFFFF),
            (ring.meta, 0xFF), (ring.payload, 0xFFFFFFFF), (ring.aux, 0),
            (missing, False)]
    got = kernels.rank_compact_many(cols, slot, b)
    fb = cfg.forward_buffer
    bw = cfg.response_budget + cfg.push_inbox
    _, fslot = slots(0.5, n, bw, fb)
    fcols = [(x.u32(n, bw), 0xFFFFFFFF), (x.u32(n, bw), 0xFFFFFFFF),
             (x.u8(n, bw), 0xFF), (x.u32(n, bw), 0xFFFFFFFF),
             (x.u16(n, bw), 0xFFFF)]
    fgot = kernels.rank_compact_many(fcols, fslot, fb)
    kept = int((slot < b).sum())
    moved = (nbytes(slot) + kept * sum(c.element_size() for c, _ in cols)
             + nbytes(*got))
    return [timed_entry(
        "rank_compact_many_diet_serve", "cuda",
        "dispersy_tpu_torch/csrc/compact.cu", "dispersy_tpu/ops/store.py:140",
        got + fgot,
        st.rank_compact_many_plain(cols, slot, b)
        + st.rank_compact_many_plain(fcols, fslot, fb),
        lambda: kernels.rank_compact_many(cols, slot, b),
        lambda: st.rank_compact_many_plain(cols, slot, b), moved, reps,
        kernel="rank_compact_many")]


def check_diet_intake(x: Draw, reps: int) -> list:
    """K5 without a store operand: the in-batch dedup of the [N, 24]
    intake batch (the digest query does the freshness test)."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    cfg, n = x.cfg, x.cfg.n_peers
    b = cfg.response_budget + cfg.push_inbox
    member, gt = x.u32(n, b, hi=4), x.u32(n, b, hi=12)
    ok = x.flags(0.8, n, b)
    got = kernels.dup_earlier(member, gt, ok)
    if not bool(got.any()):
        fail("dup_earlier inputs never hit")
    return [timed_entry(
        "dup_earlier", "triton", "dispersy_tpu_torch/kernels/intake_triton.py",
        "dispersy_tpu/ops/intake.py:137", [got],
        [intake.dup_earlier_plain(member, gt, ok)],
        lambda: kernels.dup_earlier(member, gt, ok),
        lambda: intake.dup_earlier_plain(member, gt, ok),
        nbytes(member, gt, ok) + n * b, reps, ops=2 * n * b * b)]


DIET_KERNEL_CHECKS = (check_diet_deliver, check_diet_bloom, check_diet_stage,
                      check_diet_store, check_diet_compact, check_diet_intake)


# ---- phase 2, the permissioned round's call shapes ---------------------------

def grant_table(x: Draw, n: int, a: int):
    """Random [N, A] grant tables: members and global times from small
    ranges (so queries hit, and grant and revoke rows tie), nibble masks
    over the three metas, empty slots."""
    from dispersy_tpu_torch.ops import timeline as tl
    np = x.np
    live = x.rs.random((n, a)) < 0.7
    member = np.where(live, x.rs.integers(0, 64, size=(n, a)), 0xFFFFFFFF)
    return tl.AuthTable(member=x.from_u32(member), mask=x.u32(n, a, hi=1 << 12),
                        gt=x.u32(n, a, hi=40), rev=x.flags(0.3, n, a),
                        issuer=x.from_u32(np.where(live, x.rs.integers(
                            0, 64, size=(n, a)), 0xFFFFFFFF)))


def check_timeline(x: Draw, reps: int) -> list:
    """K8 at the intake batch's [N, 24] queries: ``check`` (u8 metas
    among them out of the nibble range, a founder column) and
    ``check_grant`` (AUTHORIZE bits over the three metas); ``check`` also
    at the retro pass's [N, 48] and the author gate's [N, 1] queries.
    Bytes: the table's four columns (13 B a slot), the queries, the
    founder column, the verdicts."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import PERM_AUTHORIZE, PERM_PERMIT
    from dispersy_tpu_torch.ops import timeline as tl
    cfg, n = x.cfg, x.cfg.n_peers
    a, m = cfg.k_authorized, cfg.msg_capacity
    b = cfg.response_budget + cfg.push_inbox
    tab = grant_table(x, n, a)
    founder = x.u32(n, 1, hi=64)
    rows = []

    def queries(q):
        meta = torch.from_numpy(x.rs.choice(
            x.np.array([0, 1, 2, 0xF0, 0xF5], x.np.uint8), size=(n, q))).to(
                x.dev)
        return x.u32(n, q, hi=64), meta, x.u32(n, q, hi=48)
    member, meta, gt = queries(b)
    got = [kernels.timeline_check(tab, member, meta, gt, founder,
                                  PERM_PERMIT)]
    want = [tl.check_plain(tab, member, meta, gt, founder, PERM_PERMIT)]
    for q in (m, 1):
        qm, qt, qg = queries(q)
        got.append(kernels.timeline_check(tab, qm, qt, qg, 8, PERM_AUTHORIZE))
        want.append(tl.check_plain(tab, qm, qt, qg, 8, PERM_AUTHORIZE))
    if not bool(got[0].any()) or bool(got[0].all()):
        fail("timeline_check inputs give a constant answer")
    rows.append(timed_entry(
        "timeline_check", "cuda", "dispersy_tpu_torch/csrc/timeline.cu",
        "dispersy_tpu/ops/timeline.py:100", got, want,
        lambda: kernels.timeline_check(tab, member, meta, gt, founder,
                                       PERM_PERMIT),
        lambda: tl.check_plain(tab, member, meta, gt, founder, PERM_PERMIT),
        13 * n * a + nbytes(member, meta, gt, founder) + n * b, reps))
    mask = x.u32(n, b, hi=1 << 12)
    got = kernels.timeline_check_grant(tab, member, mask, gt, cfg.n_meta,
                                       PERM_AUTHORIZE)
    want = tl.check_grant_plain(tab, member, mask, gt, cfg.n_meta,
                                PERM_AUTHORIZE)
    if not bool(got.any()):
        fail("timeline_check_grant inputs never grant")
    rows.append(timed_entry(
        "timeline_check_grant", "cuda", "dispersy_tpu_torch/csrc/timeline.cu",
        "dispersy_tpu/ops/timeline.py:133", [got], [want],
        lambda: kernels.timeline_check_grant(tab, member, mask, gt,
                                             cfg.n_meta, PERM_AUTHORIZE),
        lambda: tl.check_grant_plain(tab, member, mask, gt, cfg.n_meta,
                                     PERM_AUTHORIZE),
        13 * n * a + nbytes(member, mask, gt) + n * b, reps))
    return rows


def check_store_match(x: Draw, reps: int) -> list:
    """K9 in each mode at the intake's shapes -- the [N, 24] batch queries
    against the [N, 48] ring (``flip``, ``undo_marked``, ``meta_of``),
    ``undo_hits``'s [N, 48] ring rows against the [N, 24] batch -- and at
    the retro pass's [N, 48] vs [N, 48] (``flip``, ``meta_of``,
    ``undo_marked``).  Bytes (``profiling.k9_bytes``): the selecting
    column (flag, meta or valid) in full, the key and value columns only
    at the slots it selects, every query, every output."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.profiling import (k9_bytes, match_cases,
                                              replay_store)
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    b = cfg.response_budget + cfg.push_inbox
    stc = replay_store(x, n, m)
    cases = match_cases(stc, x.u32(n, b, hi=16), x.u32(n, b, hi=40),
                     x.u8(n, b, hi=4), x.flags(0.5, n, b))
    rows = []
    for name, (mode, w_cols, q_cols, plain, replaces) in cases.items():
        got = kernels.store_match(mode, w_cols, q_cols)
        want = plain()
        hit = got.view(torch.int32) != (0 if mode == "flip" else 0xFFFF) \
            if got.dtype == torch.uint32 else got
        if not bool(hit.any()) or bool(hit.all()):
            fail(f"store_match {name} inputs give a constant answer")
        rows.append(timed_entry(
            f"store_match_{name}", "cuda", "dispersy_tpu_torch/csrc/match.cu",
            replaces, [got], [want],
            lambda w_cols=w_cols, q_cols=q_cols, mode=mode:
            kernels.store_match(mode, w_cols, q_cols),
            plain, k9_bytes(mode, w_cols, q_cols, got), reps,
            kernel=f"store_match_{mode}"))
    return rows


def check_store_match_corners(x: Draw, reps: int) -> list:
    """K9 on the inputs its selection and its unsigned order branch on,
    untimed, bit-equal to the plain version (64K rows, every mode at
    each case): Q = 1, 24 and 48 queries; no entry selected and every
    entry selected; global times and query times at and above 2^31;
    ``meta_of`` with several stored rows of one (member, gt)."""
    np, torch = x.np, x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import META_DYNAMIC, META_UNDO_OWN
    from dispersy_tpu_torch.profiling import match_cases, replay_store
    n, m = 1 << 16, x.cfg.msg_capacity
    big = 1 << 31

    def ring(metas, high=False):
        stc = replay_store(x, n, m)
        if metas is not None:
            stc = stc._replace(meta=torch.full_like(stc.meta, metas))
        if high:
            stc = stc._replace(gt=x.from_u32(big + x.rs.integers(
                -2, 3, size=(n, m))), aux=x.from_u32(big + x.rs.integers(
                    -2, 3, size=(n, m))))
        return stc

    def queries(q, high=False):
        lo = big - 2 if high else 0
        hi = big + 3 if high else 40
        return (x.u32(n, q, hi=16), x.from_u32(x.rs.integers(
            lo, hi, size=(n, q))), x.u8(n, q, hi=4), x.flags(0.5, n, q))

    stores = {"random": ring(None), "none": ring(0xFF),
              "all_flips": ring(META_DYNAMIC), "all_undo": ring(META_UNDO_OWN),
              "all_user": ring(1), "high_gt": ring(None, high=True)}
    dup = ring(None)
    # Several stored rows of one (member, gt): copy slot 0's keys into
    # slots 1-5 (the metas stay as drawn).
    for c in ("member", "gt"):
        col = getattr(dup, c).view(torch.int32)
        col[:, 1:6] = col[:, :1]
    stores["dup_keys"] = dup
    for sname, stc in stores.items():
        for q in (1, 24, m):
            qs = queries(q, high=sname == "high_gt")
            if sname == "none":
                qs = (*qs[:3], torch.zeros_like(qs[3]))
            elif sname.startswith("all"):
                qs = (*qs[:3], torch.ones_like(qs[3]))
            for name, (mode, w_cols, q_cols, plain, _) in match_cases(
                    stc, *qs).items():
                if name.endswith("_retro") and q != m:
                    continue
                err = max_abs_err([kernels.store_match(mode, w_cols,
                                                       q_cols)], [plain()])
                if err != 0:
                    fail(f"kernel store_match {name} corner {sname} Q = {q} "
                         f"disagrees with its plain version (max abs err "
                         f"{err})")
        print(f"kernel store_match corner {sname}: mismatches 0 (untimed, "
              f"every mode, Q = 1, 24 and {m})", flush=True)
    return []


def check_remove(x: Draw, reps: int) -> list:
    """K10 on the [N, 48] ring with a kill mask.  Bytes: the gt column and
    the mask, the survivors' other five columns (14 B), every output."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    store, _ = store_inputs(x)
    n, m = store.gt.shape
    kill = x.flags(0.2, n, m)
    got = list(kernels.store_remove(store, kill))
    want = st.store_remove_plain(store, kill)
    kept = int((got[0].view(x.torch.int32) != -1).sum())
    if not bool(want.n_removed.any()):
        fail("store_remove inputs remove nothing")
    return [timed_entry(
        "store_remove", "cuda", "dispersy_tpu_torch/csrc/remove.cu",
        "dispersy_tpu/ops/store.py:577", got, [*want.store, want.n_removed],
        lambda: kernels.store_remove(store, kill),
        lambda: st.store_remove_plain(store, kill),
        4 * n * m + nbytes(kill) + 14 * kept + nbytes(*got), reps)]


def check_store_history(x: Draw, reps: int) -> list:
    """K3 with the permissioned config's LastSync history (meta 2 keeps
    its newest record per member) at the intake merge [N, 48] + [N, 24]
    and at the one-record insert [N, 48] + [N, 1]."""
    from dispersy_tpu_torch.ops import store as st
    hist = x.cfg.history
    store, batch = store_inputs(x)
    mask = x.flags(0.6, *batch.gt.shape)
    want = st.store_insert_plain(store, batch, mask, hist)
    plain = st.store_insert_plain(store, batch, mask)
    if not bool((want.n_evicted + want.n_dropped
                 > plain.n_evicted + plain.n_dropped).any()):
        fail("store_insert history inputs never evict")
    rows = [k3_row(x, "store_insert_history", store, batch, mask, hist,
                   reps)]
    store, batch = store_inputs(x, 1)
    rows.append(k3_row(x, "store_insert_history_one", store, batch,
                       x.flags(1 / 64, *batch.gt.shape), hist, reps))
    return rows


PERM_KERNEL_CHECKS = (check_timeline, check_store_match,
                      check_store_match_corners, check_remove,
                      check_store_history)


# ---- phase 2, the hardened round's call shapes -------------------------------

def probe_inputs(x: Draw, n: int, m: int, b: int):
    """A ring of user, identity and proof records with empty slots, keys
    from small ranges and values at and above 2^31, and an [N, B] batch
    that copies ring slots (some with the meta, payload or aux changed)
    or draws fresh keys: planted hits for every K11 mode."""
    np = x.np
    from dispersy_tpu_torch.ops import store as st
    rs = x.rs
    gts = np.array([1, 2, 3, 1 << 31, (1 << 31) + 5, 0xFFFFFFFE], np.uint32)
    metas = np.array([0, 1, 0xF6, 0xF7], np.uint8)
    live = rs.random((n, m)) < 0.8
    cols = [np.where(live, rs.choice(gts, size=(n, m)), 0xFFFFFFFF),
            np.where(live, rs.integers(0, 6, size=(n, m)), 0xFFFFFFFF),
            np.where(live, rs.choice(metas, size=(n, m)), 0xFF),
            rs.choice(gts, size=(n, m)), rs.choice(gts, size=(n, m))]
    pick = rs.integers(0, m, size=(n, b))
    rows = np.arange(n)[:, None]
    q = [c[rows, pick] for c in (cols[1], cols[0], cols[2], cols[3],
                                 cols[4])]
    fresh = rs.random((n, b)) < 0.3
    q[0] = np.where(fresh, rs.integers(0, 7, size=(n, b)), q[0])
    q[1] = np.where(fresh, rs.choice(gts, size=(n, b)), q[1])
    for i, pool in ((2, metas), (3, gts), (4, gts)):
        q[i] = np.where(rs.random((n, b)) < 0.2, rs.choice(pool, size=(n, b)),
                        q[i])

    def u8(a):
        return x.torch.from_numpy(a.astype(np.uint8)).to(x.dev)
    stc = st.StoreCols(gt=x.from_u32(cols[0]), member=x.from_u32(cols[1]),
                       meta=u8(cols[2]), payload=x.from_u32(cols[3]),
                       aux=x.from_u32(cols[4]), flags=u8(np.zeros((n, m))))
    return stc, (x.from_u32(q[0]), x.from_u32(q[1]), u8(q[2]),
                 x.from_u32(q[3]), x.from_u32(q[4]))


def check_store_probe(x: Draw, reps: int) -> list:
    """K11 in each mode at the intake's [N, 24] batch against the [N, 48]
    ring.  Bytes: what the function must read -- every query column and
    the ring's selecting columns in full ((member, gt) for ``conflict``,
    the meta for ``identity``, (member, meta) for ``seq_max``), the other
    columns only at the slots that select (a live row of the queried
    (member, gt), an identity row, a live row of the queried (member,
    meta)) -- and the output."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import META_IDENTITY
    from dispersy_tpu_torch.ops import intake
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    b = cfg.response_budget + cfg.push_inbox
    stc, (member, gt, meta, payload, aux) = probe_inputs(x, n, m, b)
    sm, sg = stc.member.view(torch.int32), stc.gt.view(torch.int32)
    live = sg != -1
    same_mg = torch.zeros((n, m), dtype=torch.bool, device=x.dev)
    same_mt = torch.zeros_like(same_mg)
    for j in range(b):     # the ring slots some query selects
        qm = member.view(torch.int32)[:, j:j + 1]
        same_mg |= (sm == qm) & (sg == gt.view(torch.int32)[:, j:j + 1])
        same_mt |= (sm == qm) & (stc.meta == meta[:, j:j + 1])
    n_mg = int((same_mg & live).sum())
    n_mt = int((same_mt & live).sum())
    n_id = int((stc.meta == META_IDENTITY).sum())
    nb = n * b
    cases = {
        "conflict": (
            (stc.gt, stc.member, stc.meta, stc.payload, stc.aux),
            (member, gt, meta, payload, aux),
            lambda: intake.conflict_plain(stc, member, gt, meta, payload,
                                          aux),
            8 * n * m + 9 * n_mg + 17 * nb + nb, 5,
            "dispersy_tpu/ops/intake.py:104"),
        "identity": (
            (stc.meta, stc.member), (member,),
            lambda: intake.identity_stored_plain(stc, member),
            n * m + 4 * n_id + 4 * nb + nb, 2,
            "dispersy_tpu/ops/intake.py:269"),
        "seq_max": (
            (stc.gt, stc.member, stc.meta, stc.aux), (member, meta),
            lambda: intake.seq_stored_max_plain(stc, member, meta),
            5 * n * m + 8 * n_mt + 5 * nb + 4 * nb, 3,
            "dispersy_tpu/ops/intake.py:325"),
    }
    rows = []
    for mode, (s_cols, q_cols, plain, moved, cmps, replaces) in cases.items():
        got = kernels.store_probe(mode, s_cols, q_cols)
        if got.dtype == torch.uint32:
            g = got.view(torch.int32)
            hit = g != 0
            if not bool((g < 0).any()):
                fail("store_probe seq_max inputs never reach 2^31")
        else:
            hit = got
        if not bool(hit.any()) or bool(hit.all()):
            fail(f"store_probe {mode} inputs give a constant answer")
        rows.append(timed_entry(
            f"store_probe_{mode}", "triton",
            "dispersy_tpu_torch/kernels/intake_triton.py", replaces, [got],
            [plain()],
            lambda s_cols=s_cols, q_cols=q_cols, mode=mode:
            kernels.store_probe(mode, s_cols, q_cols),
            plain, moved, reps, ops=cmps * n * b * m))
    return rows


HARD_KERNEL_CHECKS = (check_store_probe,)


# ---- phase 2, the chaos round's call shapes ---------------------------------

def push_blast(x: Draw):
    """The chaos round's push blast at 1M: the forward fan-out plus the
    flooders' junk, six columns (u32 aux, the junk flag), a share
    ``P_PUSH`` of valid edges, and the admission class of each meta."""
    from dispersy_tpu_torch.ops import overload as ovo
    cfg, n = x.cfg, x.cfg.n_peers
    fm = cfg.faults
    e = (n * cfg.forward_buffer * cfg.forward_fanout
         + len(fm.flood_senders) * fm.flood_fanout)
    cols = [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u32(e),
            x.flags(0.001, e)]
    cls = ovo.admission_class(cols[2], cfg.n_meta,
                              cfg.priorities).to(x.torch.uint8)
    dst = x.torch.from_numpy(x.rs.integers(-1, n + 1, size=e)
                             .astype(x.np.int32)).to(x.dev)
    return e, cols, cls, dst, x.flags(P_PUSH, e)


def row_sort_key(x: Draw, dst, valid, cls, n, shards):
    """The packed (destination, class, position) key of each [S, El] row
    (the source sort's order; one ``torch.sort`` computes it)."""
    torch = x.torch
    e = dst.shape[0]
    el = -(-e // shards)
    ok = valid & (dst >= 0) & (dst < n)
    key = torch.full((shards * el,), n, dtype=torch.int64, device=x.dev)
    key[:e] = torch.where(ok, dst.long(), n)
    c = torch.zeros(shards * el, dtype=torch.int64, device=x.dev)
    if cls is not None:
        c[:e] = cls.long()
    lpos = torch.arange(shards * el, device=x.dev) % el
    return ((key * 256 + c) * el + lpos).reshape(shards, el)


def ragged_case(x: Draw, dst, valid, cols, n, q, shards, budget, cls,
                receipts):
    """K12 and its plain version on one edge list: ``(kernel outputs,
    plain outputs)``, inboxes, valid mask, drops, receipts, shed."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    out = kernels.deliver_ragged(dst, cols, valid, n, q, shards, budget, cls,
                                 receipts)
    want = inbox.deliver_ragged_plain(dst, cols, valid, n, q, shards, budget,
                                      cls, receipts)
    return ([*out[0], *out[1:]],
            [*want.delivery.inbox, *want.delivery[1:], want.shed])


def k12_row(x: Draw, name, dst, valid, cols, n, q, shards, budget, cls,
            receipts, got, want, reps) -> dict:
    """A K12 kernels-JSON row: ``got`` held against ``want``, then K12,
    its plain version and ``torch.sort`` of the [S, El] rows' packed
    (destination, class, position) key timed on the same edges.  The
    bound counts dst and valid (and the class) of every edge, the row of
    every landed edge, the [N, Q] inboxes and their mask, the drops, the
    receipts and the shed stream."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    e = dst.shape[0]
    landed = int(got[len(cols)].sum())
    row_b = sum(c[:1].numel() * c.element_size() for c in cols)
    moved = ((5 if cls is None else 6) * e + landed * row_b
             + n * q * (row_b + 1) + 4 * n + 5 * e)
    key = row_sort_key(x, dst, valid, cls, n, shards)
    return timed_entry(
        name, "cuda", "dispersy_tpu_torch/csrc/ragged.cu",
        "dispersy_tpu/ops/inbox.py:217", got, want,
        lambda: kernels.deliver_ragged(dst, cols, valid, n, q, shards, budget,
                                       cls, receipts),
        lambda: inbox.deliver_ragged_plain(dst, cols, valid, n, q, shards,
                                           budget, cls, receipts),
        moved, reps, library_fn=lambda: torch.sort(key, dim=1),
        kernel="deliver_ragged")


def check_chaos_deliver(x: Draw, reps: int) -> list:
    """K12 at the sharded chaos round's 1M shapes, each timed: the capped
    push blast with admission classes and no receipts (its cap binds at
    ``P_PUSH``), the exact 2-column request channel with receipts, which
    must equal K1 on the same inputs, and the exact puncture-request
    (N·R + T·Rt edges) and puncture (N·R) channels, one column, no
    receipts."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers
    s, b = cfg.parallel.shards, cfg.parallel.cross_shard_budget
    q = cfg.push_inbox
    e, cols, cls, dst, valid = push_blast(x)
    got, want = ragged_case(x, dst, valid, cols, n, q, s, b, cls, False)
    landed, shed = int(got[len(cols)].sum()), int(got[-1].sum())
    print(f"K12 push blast: E {e}, valid {int(valid.sum())}, landed "
          f"{landed}, shed {shed}", flush=True)
    if not shed:
        fail("K12 push blast: the cross-shard cap never bound")
    rows = [k12_row(x, "deliver_ragged_push_cls", dst, valid, cols, n, q, s,
                    b, cls, False, got, want, reps)]
    rq = cfg.request_inbox
    req = [narrow(torch.arange(n, device=x.dev)), x.u32(n)]
    rdst = corner_dst(x, n, n)
    rvalid = x.flags(0.9, n)
    rgot, rwant = ragged_case(x, rdst, rvalid, req, n, rq, s, 0, None, True)
    k1 = kernels.deliver(rdst, req, rvalid, n, rq)
    if max_abs_err(rgot[:-1], [*k1[0], *k1[1:]]) or bool(rgot[-1].any()):
        fail("K12 at budget 0 differs from K1 on the request channel")
    rows.append(k12_row(x, "deliver_ragged_request", rdst, rvalid, req, n,
                        rq, s, 0, None, True, rgot, rwant, reps))
    t, rt = cfg.n_trackers, cfg.tracker_inbox
    for name, ep in (("deliver_ragged_puncture_request", n * rq + t * rt),
                     ("deliver_ragged_puncture", n * rq)):
        pcols = [x.u32(ep, hi=n)]
        pdst, pvalid = corner_dst(x, ep, n), x.flags(0.7, ep)
        pgot, pwant = ragged_case(x, pdst, pvalid, pcols, n, rq, s, 0, None,
                                  False)
        rows.append(k12_row(x, name, pdst, pvalid, pcols, n, rq, s, 0, None,
                            False, pgot, pwant, reps))
    return rows


def check_deliver_cls(x: Draw, reps: int) -> list:
    """K1 with admission classes on the unsharded chaos round's push
    blast (E = N·F·C + the junk, Q = 16; timed)."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    cfg, n = x.cfg, x.cfg.n_peers
    q = cfg.push_inbox
    e, cols, cls, dst, valid = push_blast(x)
    inb, *rest = kernels.deliver(dst, cols, valid, n, q, cls)
    want = inbox.deliver_plain(dst, cols, valid, n, q, cls)
    return [k1_row(x, "deliver_cls_push", dst, valid, cols, n, q,
                   [*inb, *rest], [*want.inbox, *want[1:]], reps, cls=cls,
                   kernel="deliver_cls")]


CHAOS_KERNEL_CHECKS = (check_chaos_deliver,)
CHAOS_FLAT_KERNEL_CHECKS = (check_deliver_cls,)


def kernel_phase(cfg, checks, path: str, seed: int, reps: int) -> list:
    """Run ``checks`` on one config's shapes; each row notes the main
    ``path`` whose launch counts it takes."""
    x = inputs(cfg, seed)
    rows = []
    for check in checks:
        for row in check(x, reps):
            row["_path"] = path
            rows.append(row)
        x.torch.cuda.synchronize()
    return rows


# ---- phase 3: the card against the CPU at a small population --------------

def parity_phase(cfg, seed: int, rounds: int, creates: list):
    from dispersy_tpu_torch import engine, init_state
    from dispersy_tpu_torch.bridge import assert_states_equal
    from dispersy_tpu_torch.profiling import run_creates

    gpu, cpu = (engine.seed_overlay(init_state(cfg, seed, device=d), cfg, 8)
                for d in ("cuda", "cpu"))
    t0 = time.perf_counter()
    for rnd in range(rounds):
        gpu = run_creates(gpu, cfg, creates, rnd)
        cpu = run_creates(cpu, cfg, creates, rnd)
        assert_states_equal(gpu, cpu, f"{cfg.n_peers} peers, creates before "
                            f"round {rnd}")
        gpu, cpu = engine.step(gpu, cfg), engine.step(cpu, cfg)
        assert_states_equal(gpu, cpu, f"{cfg.n_peers} peers, round {rnd}")
    print(f"parity: {cfg.n_peers} peers, {cfg.store}, timeline "
          f"{cfg.timeline_enabled}, malicious {cfg.malicious_enabled}, "
          f"{rounds} rounds, card == cpu on every leaf after every round "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return cpu


def hardened_outcome(state, cfg) -> dict:
    """The hardened round's counters (conflicts, gossiped convictions,
    rejections), summed over the peers."""
    from dispersy_tpu_torch.metrics import _u64_total
    return {k: _u64_total(getattr(state.stats, k))
            for k in ("conflicts", "convictions_rx", "msgs_rejected")}


def check_hardened_parity(state, cfg) -> None:
    """After the parity run: convictions by eyewitnesses and by gossip
    happened, only equivocators stand convicted, and every stored
    identity record carries its author's real key digest."""
    import numpy as np
    from dispersy_tpu_torch.crypto import MemberRegistry, verify_identities
    from dispersy_tpu_torch.profiling import hardened_roles
    from dispersy_tpu_torch.u32 import wide
    out = hardened_outcome(state, cfg)
    if not (out["conflicts"] and out["convictions_rx"]
            and out["msgs_rejected"]):
        fail(f"hardened parity run: no conviction or rejection: {out}")
    mal = wide(state.mal_member).cpu().numpy()
    eq = np.flatnonzero(hardened_roles(cfg.n_peers)["equivocators"])
    if not np.isin(mal[mal != 0xFFFFFFFF], eq).all():
        fail("hardened parity run: an honest member stands convicted")
    ok = verify_identities(state, cfg, MemberRegistry())
    if ok != 1.0:
        fail(f"hardened parity run: stored identities verify at {ok}")
    print(f"parity hardened: {out}, identities verify 1.0", flush=True)


def chaos_totals(state) -> dict:
    """The chaos planes' counters summed over the peers, and the count of
    peers whose health latch is set."""
    import torch
    from dispersy_tpu_torch.metrics import _u64_total
    out = {k: _u64_total(getattr(state.stats, k)) for k in (
        "xshard_shed", "msgs_shed_rate", "msgs_shed_priority",
        "msgs_corrupt_dropped", "recov_soft", "recov_backoff",
        "recov_quarantine")}
    out["health_flagged"] = int((state.health.view(torch.int32) != 0).sum())
    return out



# ---- phase 4: the main paths at full width -------------------------------

def main_phase(cfg, path: str, kernels_needed, seed: int, warmup: int,
               rounds: int, creates: list, record: tuple,
               spread=None) -> dict:
    """Drive one main path through the public entry points with the
    launch counts set to 0 just before and read just after: the creates
    of each round before its step, the coverage of ``record`` (member,
    gt, meta, payload) after each timed round.  A round's time includes
    its creates.  ``spread`` (a function of the state, default the
    coverage) must grow over the timed rounds."""
    import torch

    from dispersy_tpu_torch import engine, init_state, kernels, metrics
    from dispersy_tpu_torch.profiling import run_creates
    from dispersy_tpu_torch.storediet import phase_of

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = init_state(cfg, seed, device="cuda")
    state = engine.seed_overlay(state, cfg, 8)
    state = run_creates(state, cfg, creates, 0)
    n = cfg.n_peers
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cov, grown = [], []
    for rnd in range(warmup):
        if rnd:
            state = run_creates(state, cfg, creates, rnd)
        state = engine.step(state, cfg)
    torch.cuda.synchronize()
    chaos = cfg.faults.health_checks
    shed0 = chaos_totals(state)["xshard_shed"] if chaos else 0
    times, phases = [], []
    for rnd in range(warmup, warmup + rounds):
        a = time.perf_counter()
        state = run_creates(state, cfg, creates, rnd)
        state = engine.step(state, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - a)
        phases.append(phase_of(cfg, rnd))
        cov.append(float(engine.coverage(state, *record)))
        grown.append(float(spread(state)) if spread else cov[-1])
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # What comes out: every leaf finite and of its schema shape, rings
    # sorted with holes last, staging buffers a valid prefix, the record
    # spreading.
    for name, leaf in state.items():
        if name == "stats" or not isinstance(leaf, torch.Tensor):
            continue
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            fail(f"{path} main path: leaf {name} holds non-finite values")
    if state.store_gt.shape != (n, cfg.msg_capacity):
        fail(f"{path} main path: store_gt shape "
             f"{tuple(state.store_gt.shape)}")
    g = state.store_gt.view(torch.int32).long() & 0xFFFFFFFF
    if bool((g[:, 1:] < g[:, :-1]).any()):
        fail(f"{path} main path: a store ring is out of order")
    # K3's merge-path test: rows whose live records are not sorted by
    # (gt, member) with EMPTY only as a suffix (expected none).
    mb = state.store_member.view(torch.int32).long() & 0xFFFFFFFF
    live = g != 0xFFFFFFFF
    before = (~live[:, :-1] | (g[:, :-1] > g[:, 1:])
              | ((g[:, :-1] == g[:, 1:]) & (mb[:, :-1] > mb[:, 1:])))
    unordered = int((live[:, 1:] & before).any(1).sum())
    hole = state.sta_gt.view(torch.int32) == -1
    if bool((hole[:, :-1] & ~hole[:, 1:]).any()):
        fail(f"{path} main path: a staging buffer has a hole before a record")
    if not grown[-1] > grown[0]:
        fail(f"{path} main path: the records did not spread "
             f"({grown[0]} -> {grown[-1]})")
    snap = metrics.snapshot(state, cfg)
    if snap["walk_success"] == 0 or snap["msgs_stored"] == 0:
        fail(f"{path} main path: nothing walked or stored: {snap}")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        fail(f"{path} main path never launched {missing}: {launches}")
    extra = {}
    if cfg.timeline_enabled:
        # The retro pass ran (store_remove launches nowhere else); its
        # counts need not be non-zero at this size (a record reaches few
        # peers in 8 rounds).
        from dispersy_tpu_torch.metrics import _u64_total
        extra = {k: _u64_total(getattr(state.stats, k)) for k in (
            "msgs_rejected", "auth_unwound", "msgs_retro")}
        extra["killed"] = snap["killed"]
    if cfg.malicious_enabled:
        extra = hardened_outcome(state, cfg)
        extra["spread"] = grown
    if chaos:
        extra = chaos_totals(state)
        extra["xshard_shed_timed"] = extra["xshard_shed"] - shed0
        if cfg.parallel.cross_shard_budget and not extra["xshard_shed_timed"]:
            fail(f"{path} main path: the cross-shard cap "
                 f"{cfg.parallel.cross_shard_budget} shed nothing in the "
                 "timed rounds")

    def med(kind):
        sel = [t for t, ph in zip(times, phases) if kind in (None, ph)]
        return statistics.median(sel) * 1e3 if sel else None
    ms = med(None)
    out = {"path": path, "n_peers": n, "store": str(cfg.store),
           "setup_s": setup_s, "warmup_rounds": warmup,
           "timed_rounds": rounds, "ms_per_round": ms,
           "ms_per_quiet_round": med("quiet"),
           "ms_per_sync_round": med("sync"),
           "rounds_per_s": 1e3 / ms, "round_ms": [t * 1e3 for t in times],
           "phases": phases, "peak_mem_gib": peak / 2 ** 30,
           "coverage": cov, "store_fill": snap["store_fill"],
           "ring_unordered_rows": unordered,
           "walk_success_rate": snap["walk_success_rate"],
           **extra,
           "launches": launches, "launches_per_round": {
               k: v / (warmup + rounds) for k, v in launches.items()}}
    print(f"main {path}: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    if not (ROOT / "dispersy_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke.py runs from a checkout of the repository; "
              f"{ROOT} holds no dispersy_tpu_torch/csrc", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.profiling import (POST, SEQ_TEXT, bench_config,
                                              chaos_config, hardened_config,
                                              hardened_schedule,
                                              one_record_schedule,
                                              permissioned_config,
                                              permissioned_schedule,
                                              slice_config)

    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc[-1] if nvcc else 'nvcc ?'}",
          flush=True)
    built = kernels.build(ptxas_report=True)
    for name, val in built.items():
        if name.endswith(".ptxas"):       # registers, shared memory, spills
            print("\n".join(f"{name[:-6]}: {line.strip()}"
                            for line in val.splitlines()
                            if "Used" in line or "spill" in line),
                  flush=True)
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()
                                if not k.endswith(".ptxas")), flush=True)

    legacy, diet = slice_config(N_PEERS), bench_config(N_PEERS)
    perm, hard = permissioned_config(N_PEERS), hardened_config(N_PEERS)
    chaos = chaos_config(N_PEERS, 8, CHAOS_BUDGET)
    chaos_flat = chaos_config(N_PEERS, 0)
    rows = (kernel_phase(legacy, KERNEL_CHECKS, "legacy", SEED, REPS)
            + kernel_phase(diet, DIET_KERNEL_CHECKS, "diet", SEED, REPS)
            + kernel_phase(perm, PERM_KERNEL_CHECKS, "permissioned", SEED,
                           REPS)
            + kernel_phase(hard, HARD_KERNEL_CHECKS, "hardened", SEED,
                           REPS)
            + kernel_phase(chaos, CHAOS_KERNEL_CHECKS, "chaos", SEED, REPS)
            + kernel_phase(chaos_flat, CHAOS_FLAT_KERNEL_CHECKS,
                           "chaos_flat", SEED, REPS))
    print(f"kernels checked ({time.perf_counter() - t_start:.1f} s)",
          flush=True)
    parity_phase(slice_config(PARITY_PEERS), SEED, PARITY_ROUNDS,
                 one_record_schedule(PARITY_PEERS))
    parity_phase(bench_config(PARITY_PEERS), SEED, DIET_PARITY_ROUNDS,
                 one_record_schedule(PARITY_PEERS))
    parity_phase(permissioned_config(PARITY_PEERS), SEED, PERM_PARITY_ROUNDS,
                 permissioned_schedule(PARITY_PEERS))
    hard_p = hardened_config(PARITY_PEERS)
    check_hardened_parity(parity_phase(
        hard_p, SEED, HARD_PARITY_ROUNDS, hardened_schedule(PARITY_PEERS)),
        hard_p)
    parity = chaos_totals(parity_phase(
        chaos_config(PARITY_PEERS, 8, CHAOS_PARITY_BUDGET), SEED,
        CHAOS_PARITY_ROUNDS, one_record_schedule(PARITY_PEERS)))
    if not parity["xshard_shed"]:
        fail(f"chaos parity run: the cross-shard cap never bound: {parity}")
    print(f"parity chaos (sharded): {parity}", flush=True)
    parity = chaos_totals(parity_phase(
        chaos_config(PARITY_PEERS, 0), SEED, CHAOS_PARITY_ROUNDS,
        one_record_schedule(PARITY_PEERS)))
    if not (parity["msgs_shed_priority"] or parity["msgs_shed_rate"]):
        fail(f"chaos parity run (unsharded): nothing shed: {parity}")
    print(f"parity chaos (unsharded): {parity}", flush=True)
    one = one_record_schedule(N_PEERS)
    mains = {
        "diet": main_phase(diet, "diet", DIET_PATH, SEED, DIET_WARMUP,
                           DIET_ROUNDS, one, (64, 2, 1, 64)),
        "legacy": main_phase(legacy, "legacy", LEGACY_PATH, SEED, WARMUP,
                             ROUNDS, one, (64, 2, 1, 64)),
        # The post of peer 64 (meta 0, public): meta 1 is protected here.
        "permissioned": main_phase(
            perm, "permissioned", PERM_PATH, SEED, WARMUP, ROUNDS,
            permissioned_schedule(N_PEERS, destroy=False),
            (64, 2, POST, 64)),
        # The first sequence-text record of the first author (its clock
        # claims 2 for its identity, 3 for its post, 4 for this one); the
        # spread that must grow is the count of stored sequence-text
        # records over all peers.
        "hardened": main_phase(
            hard, "hardened", HARD_PATH, SEED, WARMUP, ROUNDS,
            hardened_schedule(N_PEERS),
            (hard.n_trackers, 4, SEQ_TEXT, hard.n_trackers + 1000),
            spread=lambda st: int((st.store_meta == SEQ_TEXT).sum())),
        "chaos": main_phase(chaos, "chaos", CHAOS_PATH, SEED, WARMUP,
                            ROUNDS, one, (64, 2, 1, 64)),
        "chaos_flat": main_phase(chaos_flat, "chaos_flat", CHAOS_FLAT_PATH,
                                 SEED, WARMUP, ROUNDS, one, (64, 2, 1, 64))}
    for row in rows:
        row["launches"] = mains[row.pop("_path")]["launches"][
            row.pop("_kernel")]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

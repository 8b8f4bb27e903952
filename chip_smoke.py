#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions; builds the CUDA kernels from ``dispersy_tpu_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, in parallel);
2. kernels: every kernel of the paths (K1-K12) on random inputs
   made with a numpy seed at the shapes the 1M-peer rounds give it -- the
   legacy ring's shapes (K1 at each of its call shapes, and the delivery
   core's corners for K1, K1 with classes and K12; K12's capped corners
   at 2 and 8 shards: a ~100k-edge crossing group, one of all 256
   classes, the boundary at a row's first edge and at the padded last
   row's last edge, budgets 1 and El - 1, a budget binding in some
   buckets only; K2's and K6's
   corners: W = 3, 15, 77, 256 by M = 1, 31, 48, unsalted, one salt and
   a salt a row, strided inbox and cohort views; K3 at the intake
   merge and the one-record insert, and K3's corners: rings out of
   order, ties, empty and overflowing rows, B = 1, 8, 24, M + B = 256,
   history groups across ring and batch, u16 aux; K4 at the outbox and
   the forward buffer, and K4's corners: widths 1-256 by W = 1-48, every
   entry spilled, no live entry, negative slots, k = 1 and 8; K5, and
   its corners: B = 1-40 by M = 1-48, rows out of order among sorted
   ones, EMPTY keys, all-EMPTY rings, keys at 2^31 and 0xFFFFFFFE),
   the byte-diet round's
   (u16 aux columns, per-row Bloom salts, K1 on the quiet request, K4 at
   the forward buffer, the cohort block, the staging
   buffer, and K7's corners: holes among a row's valid entries, full
   rows, no arrival, every arrival dropped, S = 1 and 32, each aux width
   pair, B = 0 and 200), the permissioned round's (the [N, 8] grant
   tables: K8 ``check`` at the intake's, the retro pass's and the author
   gate's shapes, ``check_grant``, the fused ``check_many`` and
   ``check_grant_rev``, and K8's corners: A = 1, 8 off a 16-byte
   address, 32; Q = 1, 24, 33, 200; a grant and a revoke tied at one gt;
   global times about 2^31 and at the top of the range; free-slot
   queries; empty masks; n_meta 0 and 9; the store
   replays in each K9 mode at the intake's and the retro pass's shapes,
   and K9's corners: Q = 1, 24, 48, nothing or everything selected,
   times at and above 2^31, several rows of one key; store_remove, and
   K10's corners: M = 1, 33, 48, u16 and u32 aux, nothing, everything
   or only dead slots killed, full rows, holes, misaligned columns; K3
   with a LastSync history), then the hardened round's
   (the store probes in each K11 mode, with planted hits, and K11's
   corners: every slot or no slot selecting, B = 1, M = 1, M = 45, N
   not a multiple of a block's rows, values at 2^31 and 0xFFFFFFFE,
   identity metas on empty slots, one key queried 24 times), then the
   chaos round's (K12 on the capped push blast with admission classes,
   drawn with the 1M round's shares, at the round's budget and at one
   that binds nowhere, on the exact request channel with receipts, where
   it must also equal K1, and on the exact puncture channels; K1 with
   classes on the unsharded push blast)
   -- held bit
   for bit against its plain PyTorch version on the card, and timed with
   CUDA events (queued behind a spin of the card, so that a call shorter
   than its wrapper's host work is timed by the card's work) beside the
   plain version, the bytes bound and, where one
   PyTorch call does the same work, that call (for K1 and K12
   ``torch.sort`` of the packed destination key, for K3 of the packed
   (gt, member) key); K5 on the sync-less diet round's staging is held
   and timed after that path (phase 4), on the inputs it gave K5;
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
   overload plane must shed), 20 rounds each, the observed round
   (``profiling.observed_config(4096)`` with ``p_symmetric=0.3``, the
   health sentinels and an 8-record flight recorder, four records
   tracked), the diet without sync (``profiling.syncless_config``) and
   the soak community (``profiling.soak_config(4096)`` driven by
   ``profiling.soak_schedule``, every channel's counter nonzero after
   it), 24 rounds each;
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
   invariant (``ring_unordered_rows``, expected 0); the paths that run
   K5's ``intake_checks`` also count, over the timed rounds, the store
   rows that enter a round off its search path
   (``intake_unsorted_rows``, expected 0).  Right after the diet round,
   the observed round of ``observed_config(1 << 20)`` (the diet round
   with the telemetry row, its 64-round device ring, the histograms and
   4 tracked records; 3 + 24 rounds) prints its ms per round and peak
   memory beside the diet round's, and checks that the row's round word
   is the round, that the tracked records' coverage words grow and that
   the snapshot decoded from the row equals the one reduced from the
   leaves.  Last, the diet round without sync
   (``syncless_config(1 << 20)``, 3 + 12 rounds, one compaction) runs,
   and K5 is held against its plain version and timed on the staging
   buffer and intake batch of its last round (the exact freshness test
   against the unsorted staging, off K5's search path).  Then the soak
   round of ``soak_config(1 << 20)`` (3 + 8 rounds of
   ``soak_schedule``), which fails unless every channel counter -- the
   pen's parks, the proof, sequence, message and identity replies, the
   completed and expired signature requests, the direct receipts --
   grew in the timed rounds; the inputs of its new kernel call shapes
   in its last timed round (``SoakCapture``: K1 on the signature and
   the four request channels, K4 at each serve compaction and at the
   pen rebuild, K11 on the pen and the countersigners, K8 and K9 on the
   signature inbox) are held against the plain versions and timed
   after it (``check_soak_kernels``).

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
import types
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
WARMUP, ROUNDS = 3, 5          # the legacy and permissioned main paths
DIET_WARMUP, DIET_ROUNDS = 3, 24   # the diet main path: two windows
REPS = 20                      # timed launches per kernel (median)
CORNER_ROWS = 4099             # K7's and K8's corners: not a block's multiple
SEED = 0
# The kernels each main path must launch (kernels.LAUNCHES keys).
LEGACY_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert",
               "rank_compact_many", "intake_checks")
DIET_PATH = ("deliver", "bloom_build", "bloom_query", "digest_update",
             "store_insert", "rank_compact_many", "store_stage",
             "dup_earlier")
PERM_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert_history",
             "rank_compact_many", "intake_checks", "timeline_check",
             "timeline_check_many", "timeline_check_grant",
             "timeline_check_grant_rev", "store_match_flip",
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
OBSERVED_PATH = DIET_PATH
SYNCLESS_PATH = ("deliver", "store_insert", "rank_compact_many",
                 "store_stage", "intake_checks")
OBS_PARITY_ROUNDS = SYNCLESS_PARITY_ROUNDS = 24
SYNCLESS_WARMUP, SYNCLESS_ROUNDS = 3, 12   # round 11 compacts
SOAK_PATH = ("deliver", "bloom_build", "bloom_query", "store_insert",
             "rank_compact_many", "intake_checks", "timeline_check",
             "timeline_check_many", "timeline_check_grant",
             "timeline_check_grant_rev", "store_match_flip",
             "store_match_undo_marked", "store_match_meta_of",
             "store_match_undo_hits", "store_probe_conflict",
             "store_probe_identity", "store_probe_seq_max")
SOAK_PARITY_ROUNDS = 24
SOAK_WARMUP, SOAK_ROUNDS = 3, 8
# The counters of the soak community's channels: each must grow in the
# parity run and in the main path's timed rounds.
SOAK_CHANNELS = ("msgs_delayed", "proof_records", "seq_records",
                 "mm_records", "id_records", "sig_done", "sig_expired",
                 "msgs_direct")


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
    check_ragged_corners(x, n)
    return []


def check_ragged_corners(x: Draw, n: int) -> None:
    """K12's capped corners (``profiling.ragged_corner``), untimed, each
    held bit for bit against the plain version on the card at E =
    1,000,003 (not a multiple of the shards: a padded last row) over
    ``n`` destinations, 2 and 8 shards, with classes and receipts, with
    classes alone and with neither: a crossing destination of ~100k
    edges per row with the boundary deep inside it, a crossing group
    of all 256 classes, the boundary at a row's first edge and at the
    padded last row's last edge, budgets 1 and El - 1, and a budget that
    binds in some buckets only."""
    from dispersy_tpu_torch.profiling import RAGGED_CORNERS, ragged_corner
    e, q = 1_000_003, 4
    cols = [x.u32(e), x.u8(e), x.u16(e), x.flags(0.5, e), x.u32(e, 3)]
    for s in (2, 8):
        for name in RAGGED_CORNERS:
            dst, valid, cls, budget = ragged_corner(x.rs, name, n, e, s)
            dst, valid, cls = (x.put(a) for a in (dst, valid, cls))
            for c, receipts in ((cls, True), (cls, False), (None, False)):
                got, want = ragged_case(x, dst, valid, cols, n, q, s,
                                        budget, c, receipts)
                if max_abs_err(got, want):
                    fail(f"K12 corner {name} (shards {s}, budget {budget},"
                         f" classes {c is not None}, receipts {receipts}) "
                         "disagrees with its plain version")
            print(f"K12 corner {name}: shards {s}, budget {budget}, "
                  f"shed {int(got[-1].sum())}, bit-equal", flush=True)


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


def check_bloom_corners(x: Draw, reps: int) -> list:
    """K2's build and query and K6, untimed, bit-equal to their plain
    versions at 2^16 + 3 rows: W = 3, 15, 77 and 256 words (n_bits 96,
    480, 2,464 and 8,192) by M = 1, 31 and 48 items, each unsalted, with
    one salt and with a salt a row; the query on a slot of a [N, 4, W]
    request inbox (row-strided) and on ``cohort_take``'s block of a
    digest (stride 4 W); hash pairs whose ``h1 + j * h2`` wraps past
    2^32 (counted, and most do)."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import bloom
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.ops.hashing import (BLOOM_SEED_1, BLOOM_SEED_2,
                                                hash_u32)
    from dispersy_tpu_torch.u32 import narrow
    n, k = (1 << 16) + 3, x.cfg.bloom_hashes
    for w in (3, 15, 77, 256):
        bits = 32 * w
        for m in (1, 31, 48):
            h = x.u32(n, m)
            if w == 15 and m == 48:
                h1, h2 = (hash_u32(h, s) for s in (BLOOM_SEED_1,
                                                  BLOOM_SEED_2))
                wraps = int((h1 + (k - 1) * (h2 | 1) >= 1 << 32).sum())
                if wraps < h.numel() // 2:
                    fail(f"bloom corners: {wraps} of {h.numel()} unsalted "
                         "probe chains wrap past 2^32")
            mask = x.flags(0.6, n, m)
            q = torch.where(x.flags(0.5, n, m), h.view(torch.int32),
                            x.u32(n, m).view(torch.int32)).view(torch.uint32)
            for kind, salt in (("none", None),
                               ("scalar", narrow(torch.tensor(
                                   0xFFFFFFFE, device=x.dev))),
                               ("row", x.u32(n, hi=6))):
                what = f"W = {w}, M = {m}, salt {kind}"
                built = kernels.bloom_build(h, mask, bits, k, salt)
                dig = x.u32(n, w)
                inbox = torch.stack([dig, built, dig, dig], dim=1)
                got = [built, kernels.digest_update(dig, h, mask, bits, k,
                                                    salt),
                       kernels.bloom_query(inbox[:, 1], q, bits, k, salt)]
                want = [bloom.bloom_build_plain(h, mask, bits, k, salt),
                        bloom.digest_update_plain(dig, h, mask, bits, k,
                                                  salt),
                        bloom.bloom_query_plain(inbox[:, 1], q, bits, k,
                                                salt)]
                if kind != "row":     # a cohort's block: one salt
                    blk = st.cohort_take(built[:n // 4 * 4], 1, 4)
                    qb = q[:blk.shape[0]].contiguous()
                    got.append(kernels.bloom_query(blk, qb, bits, k, salt))
                    want.append(bloom.bloom_query_plain(blk, qb, bits, k,
                                                        salt))
                err = max_abs_err(got, want)
                if err != 0:
                    fail(f"K2/K6 corner {what} disagrees with the plain "
                         f"version (max abs err {err})")
        print(f"bloom corner W = {w}: build, digest update and the strided "
              f"queries bit-equal (M = 1, 31, 48; every salt kind)",
              flush=True)
    return []


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


def compact_row(name, cols, slot, width, reps) -> dict:
    """A K4 kernels-JSON row: the kernel held against its plain version,
    then both timed.  Its bytes: the slot map, the entries whose slot is
    below the width, and every output."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    got = kernels.rank_compact_many(cols, slot, width)
    kept = int(((slot >= 0) & (slot < width)).sum())
    moved = (nbytes(slot) + kept * sum(c.element_size() for c, _ in cols)
             + nbytes(*got))
    return timed_entry(
        name, "cuda", "dispersy_tpu_torch/csrc/compact.cu",
        "dispersy_tpu/ops/store.py:140", got,
        st.rank_compact_many_plain(cols, slot, width),
        lambda: kernels.rank_compact_many(cols, slot, width),
        lambda: st.rank_compact_many_plain(cols, slot, width), moved, reps,
        kernel="rank_compact_many")


def rank_slots(x: Draw, p, rows, w, width):
    """An engine-style slot map: each entry kept with probability ``p``
    at its rank among the kept, the rest at ``width``."""
    torch = x.torch
    keep = x.flags(p, rows, w)
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    return keep, torch.where(keep & (rank < width), rank,
                             width).to(torch.int32)


def check_compact(x: Draw, reps: int) -> list:
    """K4 at the responder's outbox (six columns, one slot map over the
    store width, width = response_budget) and at the forward buffer (five
    columns over the intake batch, width = forward_buffer), each timed."""
    from dispersy_tpu_torch.ops import store as st
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    store, batch = store_inputs(x)
    b = cfg.response_budget
    missing, slot = rank_slots(x, 0.3, n, m, b)
    cols = [(store.gt, 0xFFFFFFFF), (store.member, 0xFFFFFFFF),
            (store.meta, 0xFF), (store.payload, 0xFFFFFFFF),
            (store.aux, 0), (missing, False)]
    fb = cfg.forward_buffer
    _, fslot = rank_slots(x, 0.5, n, batch.gt.shape[1], fb)
    fcols = [(c, st.empty_of(c.dtype)) for c in batch[:5]]
    return [compact_row("rank_compact_many", cols, slot, b, reps),
            compact_row("rank_compact_many_forward", fcols, fslot, fb, reps)]


def check_compact_corners(x: Draw, reps: int) -> list:
    """K4 on the inputs its gather branches on, untimed, bit-equal to the
    plain version at N = 2^16 + 3 (not a multiple of a block's rows):
    ``profiling.compact_corners`` with negative slots down to -2^31
    (widths above W leave slots no entry can reach, so an output the
    kernel did not write would show)."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import compact_arrays, compact_corners
    n = (1 << 16) + 3
    cases = compact_corners(negative=(-1, -2, -7, -(1 << 31)))
    for name, kw in cases.items():
        w, width = kw.pop("w"), kw.pop("width")
        slot, cols = compact_arrays(x.rs, n, w, width, **kw)
        slot = x.put(slot)
        cols = [(x.put(c), f) for c, f in cols]
        err = max_abs_err(kernels.rank_compact_many(cols, slot, width),
                          st.rank_compact_many_plain(cols, slot, width))
        if err != 0:
            fail(f"kernel rank_compact_many corner {name} disagrees with "
                 f"its plain version (max abs err {err})")
    print(f"kernel rank_compact_many corners: mismatches 0 in {len(cases)} "
          "cases (untimed)", flush=True)
    return []


def check_intake(x: Draw, reps: int) -> list:
    """K5 on a ring and a batch of the intake width.  The operations: a
    binary search of each entry in its ring and one warp match."""
    import math

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
        "intake_checks", "cuda", "dispersy_tpu_torch/csrc/intake.cu",
        "dispersy_tpu/ops/intake.py:80", got, plain(),
        lambda: kernels.intake_checks(*args), plain,
        nbytes(*args) + 2 * n * b, reps,
        ops=n * b * (math.ceil(math.log2(m)) + 2))]


def check_intake_corners(x: Draw, reps: int) -> list:
    """K5 on the inputs its two in_store paths and its chunked match
    branch on, untimed, bit-equal to the plain version at N = 2^16 + 3
    (not a multiple of a block's rows): ``profiling.INTAKE_CORNERS``,
    each with ``intake_checks`` and ``dup_earlier`` alone."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    from dispersy_tpu_torch.profiling import INTAKE_CORNERS, intake_arrays
    n = (1 << 16) + 3
    for name, kw in INTAKE_CORNERS.items():
        kw = dict(kw)
        sg, sm, qm, qg, ok = (x.put(a) for a in intake_arrays(
            x.rs, n, kw.pop("m"), kw.pop("b"), **kw))
        want = (intake.in_store_plain(sg, sm, qm, qg),
                intake.dup_earlier_plain(qm, qg, ok))
        err = max(max_abs_err(kernels.intake_checks(sg, sm, qm, qg, ok),
                              want),
                  max_abs_err([kernels.dup_earlier(qm, qg, ok)], want[1:]))
        if err != 0:
            fail(f"kernel intake corner {name} disagrees with its plain "
                 f"version (max abs err {err})")
    print(f"kernel intake_checks / dup_earlier corners: mismatches 0 in "
          f"{len(INTAKE_CORNERS)} cases (untimed)", flush=True)
    return []


KERNEL_CHECKS = (check_deliver, check_deliver_corners, check_bloom,
                 check_bloom_corners,
                 check_store, check_store_corners, check_compact,
                 check_compact_corners, check_intake, check_intake_corners)

# ---- phase 2, the byte-diet round's call shapes ------------------------------

def check_diet_deliver(x: Draw, reps: int) -> list:
    """K1 on the diet's push blast, whose fifth column is the forward
    buffer's u16 aux, and on the quiet round's 2-column request (the
    staggered sync round's too), each timed."""
    torch = x.torch
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers
    e = n * cfg.forward_buffer * cfg.forward_fanout
    q = cfg.push_inbox
    cols = [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u16(e)]
    dst, valid, got, want = deliver_case(x, e, n, q, cols, 0.9)
    req = [narrow(torch.arange(n, device=x.dev)), x.u32(n)]
    rdst, rvalid, rg, rw = deliver_case(x, n, n, cfg.request_inbox, req, 0.9)
    return [k1_row(x, "deliver_diet_push_u16", dst, valid, cols, n, q, got,
                   want, reps),
            k1_row(x, "deliver_diet_request", rdst, rvalid, req, n,
                   cfg.request_inbox, rg, rw, reps)]


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


def stage_case(x: Draw, n, s, b, p, fill, holes=False,
               aux=("u16", "u32")):
    """A staging buffer of ``n`` rows and ``s`` slots (valid entries a
    prefix of random length up to ``fill`` of the row, or with ``holes``
    scattered at rate ``fill``; ``fill`` 1 fills every row) and an [n, b]
    batch masked at rate ``p``; ``aux`` the staging's and the batch's aux
    widths."""
    torch, np = x.torch, x.np
    from dispersy_tpu_torch.ops import store as st
    if holes:
        live = x.rs.random((n, s)) < fill
    else:
        live = (np.arange(s)[None, :] < (x.rs.random(n) * (s + 1) * fill)
                .astype(int)[:, None])
    tl_ = torch.from_numpy(live).to(x.dev)

    def cols(rows, width, lv, kind):
        g = x.u32(rows, width, hi=200)
        a = x.u16(rows, width) if kind == "u16" else x.u32(rows, width)
        c = st.StoreCols(gt=g, member=x.u32(rows, width, hi=6),
                         meta=x.u8(rows, width, hi=4),
                         payload=x.u32(rows, width), aux=a,
                         flags=x.u8(rows, width, hi=3))
        if lv is None:
            return c
        return c._replace(gt=torch.where(lv, g.view(torch.int32), -1).view(
            torch.uint32))
    return (cols(n, s, tl_, aux[0]), cols(n, b, None, aux[1]),
            x.flags(p, n, b))


def check_stage_corners(x: Draw, reps: int) -> list:
    """K7's corners, untimed, bit-equal to the plain version: valid
    entries with holes among them (cnt is a count, not a prefix length),
    every row full, no arrival, every arrival dropped, S = 1 and S = 32,
    u32 staging aux, a u16 batch aux, B past the first wave's four
    chunks, rows not filling a block."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    n = CORNER_ROWS
    cases = {
        "diet shape, holes": (n, 8, 24, 0.3, 0.7, True, ("u16", "u32")),
        "full rows": (n, 8, 24, 0.5, 1.0, False, ("u16", "u32")),
        "no arrival": (n, 8, 24, 0.0, 0.5, False, ("u16", "u32")),
        "every arrival dropped": (n, 8, 24, 1.0, 1.0, False,
                                  ("u16", "u32")),
        "S = 1": (n, 1, 24, 0.4, 0.5, False, ("u16", "u32")),
        "S = 32, u32 aux": (n, 32, 24, 0.6, 0.5, False, ("u32", "u32")),
        "S = 32, holes": (n, 32, 24, 0.6, 0.5, True, ("u32", "u16")),
        "u16 batch aux": (n, 8, 24, 0.3, 0.5, False, ("u16", "u16")),
        "u32 staging, u16 batch": (n, 8, 24, 0.3, 0.5, False,
                                   ("u32", "u16")),
        "B = 200": (n, 5, 200, 0.05, 0.3, True, ("u16", "u32")),
        "B = 0": (n, 8, 0, 0.5, 0.5, False, ("u16", "u32"))}
    for name, (n, s, b, p, fill, holes, aux) in cases.items():
        staging, batch, mask = stage_case(x, n, s, b, p, fill, holes, aux)
        want = st.store_stage_plain(staging,
                                    st.as_store_dtypes(batch, staging), mask)
        err = max_abs_err(kernels.store_stage(staging, batch, mask),
                          [*want.staging, *want[1:]])
        if err != 0:
            fail(f"kernel store_stage corner {name!r} disagrees with its "
                 f"plain version (max abs err {err})")
        if p and b and fill < 1 and not bool(want.landed.any()):
            fail(f"store_stage corner {name!r}: nothing landed")
    print(f"kernel store_stage corners: {len(cases)} cases, mismatches 0 "
          "(untimed)", flush=True)
    return []


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
    gathered rings to width 8, six columns with the u16 aux) and at the
    forward buffer ([N, 24] to width 4, the aux at u16), each timed."""
    from dispersy_tpu_torch.profiling import diet_cols
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    blk = n // cfg.store.cohorts
    ring = diet_cols(x, blk, m, prefix=False)
    b = cfg.response_budget
    missing, slot = rank_slots(x, 0.3, blk, m, b)
    cols = [(ring.gt, 0xFFFFFFFF), (ring.member, 0xFFFFFFFF),
            (ring.meta, 0xFF), (ring.payload, 0xFFFFFFFF), (ring.aux, 0),
            (missing, False)]
    fb = cfg.forward_buffer
    bw = cfg.response_budget + cfg.push_inbox
    _, fslot = rank_slots(x, 0.5, n, bw, fb)
    fcols = [(x.u32(n, bw), 0xFFFFFFFF), (x.u32(n, bw), 0xFFFFFFFF),
             (x.u8(n, bw), 0xFF), (x.u32(n, bw), 0xFFFFFFFF),
             (x.u16(n, bw), 0xFFFF)]
    return [compact_row("rank_compact_many_diet_serve", cols, slot, b,
                        reps),
            compact_row("rank_compact_many_diet_forward", fcols, fslot, fb,
                        reps)]


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
        "dup_earlier", "cuda", "dispersy_tpu_torch/csrc/intake.cu",
        "dispersy_tpu/ops/intake.py:137", [got],
        [intake.dup_earlier_plain(member, gt, ok)],
        lambda: kernels.dup_earlier(member, gt, ok),
        lambda: intake.dup_earlier_plain(member, gt, ok),
        nbytes(member, gt, ok) + n * b, reps, ops=n * b)]


DIET_KERNEL_CHECKS = (check_diet_deliver, check_diet_bloom, check_diet_stage,
                      check_stage_corners, check_diet_store,
                      check_diet_compact, check_diet_intake)


# ---- phase 2, the permissioned round's call shapes ---------------------------

def check_timeline(x: Draw, reps: int) -> list:
    """K8 at every call shape of the permissioned round: ``check`` at the
    intake batch's [N, 24] queries (u8 metas, among them metas out of the
    nibble range, a founder column), the retro pass's [N, 48] and the
    author gate's [N, 1] (u32 metas); ``check_grant`` at [N, 24]
    (AUTHORIZE bits over the three metas); the fused entries: the
    intake's ``check_many`` (undo, flip and permit pairs in one walk) and
    ``check_grant_rev`` (REVOKE where the record is a revoke) at [N, 24]
    and [N, 48].  The queries carry the round's share of free slots at
    their width (``profiling.TIMELINE_EMPTY_SHARE``).  Bytes: the table's
    four columns (13 B a slot), the queries, the founder column, the
    verdicts."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import (PERM_AUTHORIZE, PERM_PERMIT,
                                           PERM_REVOKE, PERM_UNDO)
    from dispersy_tpu_torch.ops import timeline as tl
    from dispersy_tpu_torch.profiling import grant_table, timeline_queries
    cfg, n = x.cfg, x.cfg.n_peers
    a, m, nm = cfg.k_authorized, cfg.msg_capacity, cfg.n_meta
    b = cfg.response_budget + cfg.push_inbox
    src, tab_b = "dispersy_tpu_torch/csrc/timeline.cu", 13 * n * a
    tab = grant_table(x, n, a)
    founder = x.u32(n, 1, hi=64)
    rows = []
    for name, q, u8 in (("timeline_check", b, True),
                        ("timeline_check_retro", m, True),
                        ("timeline_check_gate", 1, False)):
        args = (tab, *timeline_queries(x, n, q, u8), founder, PERM_PERMIT)
        got = kernels.timeline_check(*args)
        if not bool(got.any()) or bool(got.all()):
            fail(f"{name} inputs give a constant answer")
        rows.append(timed_entry(
            name, "cuda", src, "dispersy_tpu/ops/timeline.py:100", [got],
            [tl.check_plain(*args)], lambda args=args: kernels.timeline_check(
                *args), lambda args=args: tl.check_plain(*args),
            tab_b + nbytes(*args[1:5]) + n * q, reps,
            kernel="timeline_check"))
    member, meta8, gt = timeline_queries(x, n, b)
    _, undo_meta, _ = timeline_queries(x, n, b, u8=False)
    pairs = ((undo_meta, PERM_UNDO), (x.u32(n, b, hi=4), PERM_AUTHORIZE),
             (meta8, PERM_PERMIT))
    got = kernels.timeline_check_many(tab, member, pairs, gt, founder)
    want = tl.check_many_plain(tab, member, pairs, gt, founder)
    if not all(bool(g.any()) for g in got):
        fail("timeline_check_many inputs never hold a pair")
    rows.append(timed_entry(
        "timeline_check_many", "cuda", src,
        "dispersy_tpu/ops/timeline.py:100", got, want,
        lambda: kernels.timeline_check_many(tab, member, pairs, gt, founder),
        lambda: tl.check_many_plain(tab, member, pairs, gt, founder),
        tab_b + nbytes(member, gt, founder, *(k for k, _ in pairs))
        + 3 * n * b, reps))
    mask = x.u32(n, b, hi=1 << 12)
    got = kernels.timeline_check_grant(tab, member, mask, gt, nm,
                                       PERM_AUTHORIZE)
    if not bool(got.any()):
        fail("timeline_check_grant inputs never grant")
    rows.append(timed_entry(
        "timeline_check_grant", "cuda", src,
        "dispersy_tpu/ops/timeline.py:133", [got],
        [tl.check_grant_plain(tab, member, mask, gt, nm, PERM_AUTHORIZE)],
        lambda: kernels.timeline_check_grant(tab, member, mask, gt, nm,
                                             PERM_AUTHORIZE),
        lambda: tl.check_grant_plain(tab, member, mask, gt, nm,
                                     PERM_AUTHORIZE),
        tab_b + nbytes(member, mask, gt) + n * b, reps))
    for name, q in (("timeline_check_grant_rev", b),
                    ("timeline_check_grant_rev_retro", m)):
        g_member, _, g_gt = timeline_queries(x, n, q)
        args = (tab, g_member, x.u32(n, q, hi=1 << 12), g_gt,
                x.flags(0.5, n, q), nm)
        got = kernels.timeline_check_grant_rev(*args)
        want = x.torch.where(
            args[4], tl.check_grant_plain(*args[:4], nm, PERM_REVOKE),
            tl.check_grant_plain(*args[:4], nm, PERM_AUTHORIZE))
        if not bool(got.any()):
            fail(f"{name} inputs never grant")
        rows.append(timed_entry(
            name, "cuda", src, "dispersy_tpu/ops/timeline.py:133", [got],
            [want], lambda args=args: kernels.timeline_check_grant_rev(*args),
            lambda args=args: tl.check_grant_rev_plain(*args),
            tab_b + nbytes(*args[1:5]) + n * q, reps,
            kernel="timeline_check_grant_rev"))
    return rows


def misaligned(c):
    """A contiguous copy of the [N, A] column ``c`` one element past an
    aligned address (so a kernel cannot take its 16-byte loads)."""
    import torch
    bits = c.view({torch.bool: torch.uint8, torch.uint8: torch.uint8,
                   torch.uint16: torch.int16}.get(c.dtype, torch.int32))
    buf = torch.empty(c.numel() + 1, dtype=bits.dtype, device=c.device)
    buf[1:] = bits.reshape(-1)
    return buf[1:].view(c.shape).view(c.dtype)


def check_timeline_corners(x: Draw, reps: int) -> list:
    """K8's corners, untimed, every entry bit-equal to its plain version
    (and ``check_grant_rev`` to the ``torch.where`` of two
    ``check_grant`` calls): A = 1, 8 (with the table at an address that
    is not 16-byte aligned: the slot-by-slot path), 32; Q = 1, 24, 33,
    200 (a lane's queries in two passes); a
    grant and a revoke tied at one gt for the first query of every row;
    global times about 2^31 and at 0xFFFFFFFE-0xFFFFFFFF, in tables that
    fit the 32-bit walk and in tables that do not; a tenth of the queries
    free slots (member and gt EMPTY_U32); empty masks, masks with nibbles
    past ``n_meta`` and n_meta 0 and 9; u8 and u32 metas out of the
    nibble range; int founders (EMPTY_U32 among them) and column
    founders; rows not filling a block."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import (EMPTY_U32, PERM_AUTHORIZE,
                                           PERM_PERMIT, PERM_REVOKE,
                                           PERM_UNDO)
    from dispersy_tpu_torch.ops import timeline as tl
    from dispersy_tpu_torch.profiling import grant_table, timeline_queries
    n, cases = CORNER_ROWS, 0

    def same(got, want, what):
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"kernel {what} disagrees with its plain version (max abs "
                 f"err {err})")
    for a, q, shift in ((8, 24, False), (8, 24, True), (1, 24, False),
                        (32, 24, False), (8, 33, False), (32, 1, False),
                        (8, 1, False), (8, 200, False)):
        tab = grant_table(x, n, a)
        member, meta8, gt = timeline_queries(x, n, q, empty=0.1)
        _, meta32, _ = timeline_queries(x, n, q, u8=False)
        if a > 1:     # slot a-1 = slot 0 with the revoke flag flipped
            cols = [c.clone() for c in tab]
            for c in cols[:3] + cols[4:]:
                c.view(torch.int32)[:, a - 1] = c.view(torch.int32)[:, 0]
            cols[3][:, a - 1] = ~cols[3][:, 0]
            tab = tl.AuthTable(*cols)
            for q_col, t_col in ((member, tab.member), (gt, tab.gt)):
                q_col.view(torch.int32)[:, 0] = t_col.view(torch.int32)[:, 0]
        # Global times about 2^31 and at the top of the range, in a tenth
        # of the slots and queries: the walk's 64-bit key.
        high = x.from_u32(x.rs.choice(x.np.array(
            [0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
            x.np.uint32), size=(n, max(a, q))))
        for col, w in ((tab.gt, a), (gt, q)):
            col.view(torch.int32).copy_(torch.where(
                x.flags(0.1, n, w), high[:, :w].view(torch.int32),
                col.view(torch.int32)))
        if shift:
            tab = tl.AuthTable(*(misaligned(c) for c in tab))
        mask = x.u32(n, q, hi=1 << 12)
        mask = torch.where(x.flags(0.1, n, q), 0, mask.view(torch.int32))
        mask = torch.where(x.flags(0.1, n, q), mask | (1 << 28), mask).view(
            torch.uint32)
        is_rev = x.flags(0.5, n, q)
        for founder in (7, EMPTY_U32, x.u32(n, 1, hi=64)):
            for perm in (PERM_PERMIT, PERM_AUTHORIZE, PERM_REVOKE, PERM_UNDO):
                for meta in (meta8, meta32):
                    same([kernels.timeline_check(tab, member, meta, gt,
                                                 founder, perm)],
                         [tl.check_plain(tab, member, meta, gt, founder,
                                         perm)], "timeline_check")
            pairs = ((meta32, PERM_UNDO), (meta8, PERM_AUTHORIZE),
                     (meta8, PERM_PERMIT))
            for k in (1, 2, 3):
                same(kernels.timeline_check_many(tab, member, pairs[:k], gt,
                                                 founder),
                     tl.check_many_plain(tab, member, pairs[:k], gt,
                                         founder), "timeline_check_many")
        for nm in (0, 3, 9):
            for perm in (PERM_AUTHORIZE, PERM_REVOKE):
                same([kernels.timeline_check_grant(tab, member, mask, gt, nm,
                                                   perm)],
                     [tl.check_grant_plain(tab, member, mask, gt, nm, perm)],
                     "timeline_check_grant")
            same([kernels.timeline_check_grant_rev(tab, member, mask, gt,
                                                   is_rev, nm)],
                 [torch.where(is_rev, tl.check_grant_plain(
                     tab, member, mask, gt, nm, PERM_REVOKE),
                     tl.check_grant_plain(tab, member, mask, gt, nm,
                                          PERM_AUTHORIZE))],
                 "timeline_check_grant_rev")
        cases += 1
    print(f"kernel timeline_check corners: {cases} shapes, mismatches 0 "
          "(untimed)", flush=True)
    return []


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
    """K10 on the round's [N, 48] rings and kill masks
    (``profiling.remove_inputs``: no slot killed, 86% of slots live).
    Bytes: the gt column and the mask, the survivors' other five columns
    (14 B), every output."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import REMOVE_SHARES, remove_inputs
    n, m = x.cfg.n_peers, x.cfg.msg_capacity
    store, kill = remove_inputs(x, n, m)
    got = list(kernels.store_remove(store, kill))
    want = st.store_remove_plain(store, kill)
    kept = int((got[0].view(x.torch.int32) != -1).sum())
    rows = REMOVE_SHARES["live_rows"]
    share = sum(i * c for i, c in enumerate(rows)) / (sum(rows) * m)
    if abs(kept / (n * m) - share) > 0.01:
        fail(f"store_remove inputs: {kept / (n * m)} of slots live, the "
             f"round's rings {share}")
    return [timed_entry(
        "store_remove", "cuda", "dispersy_tpu_torch/csrc/remove.cu",
        "dispersy_tpu/ops/store.py:577", got, [*want.store, want.n_removed],
        lambda: kernels.store_remove(store, kill),
        lambda: st.store_remove_plain(store, kill),
        4 * n * m + nbytes(kill) + 14 * kept + nbytes(*got), reps)]


def check_remove_corners(x: Draw, reps: int) -> list:
    """K10 on the inputs its stages branch on, untimed, bit-equal to the
    plain version at N = 2^16 + 3 (not a multiple of a block's rows):
    ``profiling.REMOVE_CORNERS`` (M = 1, 33 and 48, u32 and u16 aux,
    half the slots, nothing, everything or only dead slots killed, full
    rows, rows with holes, no live slot), each also with the columns and the mask one
    element past an aligned address (off the 16-byte loads)."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.profiling import REMOVE_CORNERS, remove_arrays
    n = (1 << 16) + 3
    for name, kw in REMOVE_CORNERS.items():
        kw = dict(kw)
        cols, kill = remove_arrays(x.rs, n, kw.pop("m"), **kw)
        store = st.StoreCols(*(x.put(c) for c in cols))
        kill = x.put(kill)
        want = st.store_remove_plain(store, kill)
        if (kw.get("kill") in ("half", "all") and kw.get("fill") != "empty"
                and not bool(want.n_removed.any())):
            fail(f"store_remove corner {name} removes nothing")
        for form, (sc, k) in (("aligned", (store, kill)), ("misaligned", (
                st.StoreCols(*map(misaligned, store)), misaligned(kill)))):
            err = max_abs_err(kernels.store_remove(sc, k),
                              [*want.store, want.n_removed])
            if err != 0:
                fail(f"kernel store_remove corner {name} ({form}) disagrees "
                     f"with its plain version (max abs err {err})")
    print(f"kernel store_remove corners: mismatches 0 in "
          f"{len(REMOVE_CORNERS)} cases, aligned and misaligned (untimed)",
          flush=True)
    return []


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


PERM_KERNEL_CHECKS = (check_timeline, check_timeline_corners,
                      check_store_match,
                      check_store_match_corners, check_remove,
                      check_remove_corners, check_store_history)


# ---- phase 2, the hardened round's call shapes -------------------------------

def check_store_probe(x: Draw, reps: int) -> list:
    """K11 in each mode at the intake's [N, 24] batch against the [N, 48]
    ring (``profiling.probe_inputs``: planted hits for every mode).
    Bytes (``profiling.k11_cases``): what the function must read -- every
    query column and the ring's selecting columns in full ((member, gt)
    for ``conflict``, the meta for ``identity``, (member, meta) for
    ``seq_max``), the other columns only at the slots that select -- and
    the output."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.profiling import k11_cases, probe_inputs
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    b = cfg.response_budget + cfg.push_inbox
    stc, q = probe_inputs(x, n, m, b)
    rows = []
    for mode, (s_cols, q_cols, plain, moved, cmps, replaces) in k11_cases(
            stc, *q).items():
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
            f"store_probe_{mode}", "cuda", "dispersy_tpu_torch/csrc/probe.cu",
            replaces, [got], [plain()],
            lambda s_cols=s_cols, q_cols=q_cols, mode=mode:
            kernels.store_probe(mode, s_cols, q_cols),
            plain, moved, reps, ops=cmps * n * b * m))
    return rows


def check_store_probe_corners(x: Draw, reps: int) -> list:
    """K11 on the inputs its selection and its unsigned order branch on,
    untimed, bit-equal to the plain version in every mode: every slot and
    no slot selecting (all identity records, all slots empty, every slot
    the queried (member, gt)); B = 1 and M = 1; M = 45, not a multiple of
    the group's 8 lanes, and N = 2^16 + 3 rows, not a multiple of a
    block's; gt and aux at 2^31 and 0xFFFFFFFE (``probe_inputs`` draws
    them); an identity meta on EMPTY-gt slots; all 24 queries one (member,
    gt).  The hit counts show each case answers as named."""
    np, torch = x.np, x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import META_IDENTITY
    from dispersy_tpu_torch.profiling import k11_cases, probe_inputs
    n, m, b = (1 << 16) + 3, x.cfg.msg_capacity, 24

    def full(col, v):
        if col.dtype == torch.uint8:
            return torch.full_like(col, v)
        return x.from_u32(np.full(tuple(col.shape), v, np.uint32))

    cases = {}
    for shape in ((n, m, b), (n, 1, 1), (n, m, 1), (n, 1, b), (n, 45, b)):
        cases[f"random {shape}"] = probe_inputs(x, *shape)
    stc, q = probe_inputs(x, n, m, b)
    cases["all identity"] = (stc._replace(meta=full(stc.meta, META_IDENTITY)),
                             q)
    cases["all empty, identity metas"] = (stc._replace(
        gt=full(stc.gt, 0xFFFFFFFF),
        meta=full(stc.meta, META_IDENTITY)), q)
    cases["all empty, no identity"] = (stc._replace(
        gt=full(stc.gt, 0xFFFFFFFF), meta=full(stc.meta, 0)), q)
    one = tuple(c[:, :1].expand(n, b).contiguous() for c in q)
    cases["one (member, gt) queried 24 times"] = (stc, one)
    # Every slot the first query's (member, gt, meta), payloads and aux
    # as drawn: every slot matches every query of ``one``.
    cases["every slot the queried key"] = (stc._replace(
        member=one[0][:, :1].expand(n, m).contiguous(),
        gt=one[1][:, :1].expand(n, m).contiguous(),
        meta=one[2][:, :1].expand(n, m).contiguous()), one)
    for name, (stc, q) in cases.items():
        hits = {}
        for mode, (s_cols, q_cols, plain, _, _, _) in k11_cases(
                stc, *q).items():
            got = kernels.store_probe(mode, s_cols, q_cols)
            err = max_abs_err([got], [plain()])
            if err != 0:
                fail(f"kernel store_probe {mode} corner {name} disagrees "
                     f"with its plain version (max abs err {err})")
            hits[mode] = int((got.view(torch.int32) != 0).sum()
                             if got.dtype == torch.uint32 else got.sum())
        print(f"kernel store_probe corner {name}: mismatches 0 (untimed, "
              f"every mode; nonzero answers {hits} of {q[0].numel()})",
              flush=True)
    return []


HARD_KERNEL_CHECKS = (check_store_probe, check_store_probe_corners)


# ---- phase 2, the chaos round's call shapes ---------------------------------

def push_blast(x: Draw):
    """The chaos round's push blast at 1M: the forward fan-out plus the
    flooders' junk, six columns (u32 aux, the junk flag), valid edges,
    destinations and admission classes drawn with the 1M round's shares
    (``profiling.push_blast_arrays``)."""
    from dispersy_tpu_torch.profiling import push_blast_arrays
    dst, valid, cls = (x.put(a) for a in push_blast_arrays(x.rs, x.cfg))
    e = dst.shape[0]
    cols = [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u32(e),
            x.flags(0.001, e)]
    return e, cols, cls, dst, valid


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
    push blast with admission classes and no receipts (drawn with the
    round's shares; its cap binds in every bucket, as in the round), the
    same blast at a budget above every bucket's count and below El (it
    binds nowhere), the exact 2-column request channel with receipts,
    which must equal K1 on the same inputs, and the exact
    puncture-request (N·R + T·Rt edges) and puncture (N·R) channels, one
    column, no receipts."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.profiling import ragged_bounds
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers
    s, b = cfg.parallel.shards, cfg.parallel.cross_shard_budget
    q = cfg.push_inbox
    e, cols, cls, dst, valid = push_blast(x)
    got, want = ragged_case(x, dst, valid, cols, n, q, s, b, cls, False)
    landed, shed = int(got[len(cols)].sum()), int(got[-1].sum())
    bounds = ragged_bounds(dst, valid, cls, n, s, b)
    print(f"K12 push blast: E {e}, valid {int(valid.sum())}, landed "
          f"{landed}, shed {shed}, binding buckets "
          f"{int(bounds['binding'].sum())} of {s * s}", flush=True)
    if not bool(bounds["binding"].all()):
        fail("K12 push blast: the cross-shard cap did not bind in every "
             "bucket")
    rows = [k12_row(x, "deliver_ragged_push_cls", dst, valid, cols, n, q, s,
                    b, cls, False, got, want, reps)]
    free = int(bounds["count"].max()) + 1
    if free >= bounds["el"]:
        fail(f"K12 push blast: no budget below El {bounds['el']} is free")
    got, want = ragged_case(x, dst, valid, cols, n, q, s, free, cls, False)
    if bool(got[-1].any()):
        fail(f"K12 push blast at budget {free}: the cap bound")
    rows.append(k12_row(x, "deliver_ragged_push_cls_unbound", dst, valid,
                        cols, n, q, s, free, cls, False, got, want, reps))
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


def counter_totals(state, names) -> dict:
    """The ``names`` counters summed over the peers."""
    from dispersy_tpu_torch.metrics import _u64_total
    return {k: _u64_total(getattr(state.stats, k)) for k in names}


def check_soak_parity(state) -> None:
    """After the soak parity run: every channel's counter moved."""
    tot = counter_totals(state, SOAK_CHANNELS)
    if not all(tot.values()):
        fail(f"soak parity run: a channel stayed idle: {tot}")
    print(f"parity soak: {tot}", flush=True)


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
               spread=None, channels=()) -> dict:
    """Drive one main path through the public entry points with the
    launch counts set to 0 just before and read just after: the creates
    of each round before its step, the coverage of ``record`` (member,
    gt, meta, payload) after each timed round.  A round's time includes
    its creates.  ``spread`` (a function of the state, default the
    coverage) must grow over the timed rounds, and so must each counter
    of ``channels``."""
    import torch

    from dispersy_tpu_torch import engine, init_state, kernels, metrics
    from dispersy_tpu_torch.profiling import (intake_unsorted_rows,
                                              run_creates)
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
    chan0 = counter_totals(state, channels)
    times, phases = [], []
    searched = "intake_checks" in kernels_needed
    off_search = 0
    observed = cfg.telemetry.enabled
    row_rounds, tracked_cov = [], []
    alloc0 = torch.cuda.memory_stats()
    for rnd in range(warmup, warmup + rounds):
        if searched:
            off_search += intake_unsorted_rows(state)
        a = time.perf_counter()
        state = run_creates(state, cfg, creates, rnd)
        state = engine.step(state, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - a)
        phases.append(phase_of(cfg, rnd))
        cov.append(float(engine.coverage(state, *record)))
        grown.append(float(spread(state)) if spread else cov[-1])
        if observed:
            # Read after the timed window: the row's round word and the
            # tracked records' coverage words.
            snap = metrics.snapshot(state, cfg)
            row_rounds.append(snap["round"])
            tracked_cov.append([snap[f"trace_cov_{k}"] for k in range(
                cfg.trace.tracked_slots)])
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # The caching allocator's cudaMalloc and cudaFree calls in the timed
    # rounds (each costs the host a synchronisation) and its retries.
    alloc1 = torch.cuda.memory_stats()
    allocator = {k: alloc1.get(key, 0) - alloc0.get(key, 0) for k, key in (
        ("cuda_malloc", "segment.all.allocated"),
        ("cuda_free", "segment.all.freed"), ("retries", "num_alloc_retries"))}

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
        extra.update(hardened_outcome(state, cfg))
        extra["spread"] = grown
    if channels:
        chan1 = counter_totals(state, channels)
        timed = {k: chan1[k] - chan0[k] for k in channels}
        if not all(timed.values()):
            fail(f"{path} main path: a channel stayed idle in the timed "
                 f"rounds: {timed}")
        extra["channels_timed"] = timed
    if observed:
        extra = observed_checks(state, cfg, path, warmup, row_rounds,
                                tracked_cov)
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
           "allocator_timed": allocator,
           "coverage": cov, "store_fill": snap["store_fill"],
           "ring_unordered_rows": unordered,
           **({"intake_unsorted_rows": off_search} if searched else {}),
           "walk_success_rate": snap["walk_success_rate"],
           **extra,
           "launches": launches, "launches_per_round": {
               k: v / (warmup + rounds) for k, v in launches.items()}}
    print(f"main {path}: " + json.dumps(out), flush=True)
    return out


def observed_checks(state, cfg, path: str, warmup: int, row_rounds: list,
                    tracked_cov: list) -> dict:
    """The observed path's checks: the row's round word is the round
    after every timed round, every tracked record's coverage word grew
    over the timed rounds, and the snapshot decoded from the row has the
    keys of the one reduced from the leaves and equals it on each but
    the histograms' (which only the round has): integers exactly,
    floats -- the occupancy means, which the leaves' path takes in
    float32 -- to a relative 1e-6."""
    from dispersy_tpu_torch import metrics
    want = list(range(warmup + 1, warmup + 1 + len(row_rounds)))
    if row_rounds != want:
        fail(f"{path} main path: the row's round words {row_rounds} are "
             f"not the rounds {want}")
    first, last = tracked_cov[0], tracked_cov[-1]
    if not all(b > a for a, b in zip(first, last)):
        fail(f"{path} main path: tracked coverage did not grow "
             f"({first} -> {last})")
    fused = metrics.snapshot(state, cfg)
    legacy = metrics.legacy_snapshot(state, cfg)
    if fused.keys() != legacy.keys():
        fail(f"{path} main path: row snapshot keys "
             f"{sorted(set(fused) ^ set(legacy))} differ")
    # The histograms exist only in the round (the leaves' path reports
    # them empty).
    shared = [k for k in fused if not k.startswith("hist_")]
    bad = [k for k in shared if (
        abs(fused[k] - legacy[k]) > 1e-6 * abs(legacy[k])
        if isinstance(fused[k], float) and k != "trace_redundancy"
        else fused[k] != legacy[k])]
    if bad:
        fail(f"{path} main path: row snapshot != leaf snapshot on "
             f"{[(k, fused[k], legacy[k]) for k in bad]}")
    return {"row_rounds_ok": True, "tracked_cov_first": first,
            "tracked_cov_last": last, "snapshot_keys_equal": len(shared),
            "trace_redundancy": fused["trace_redundancy"],
            "hist_p99": {k: v for k, v in fused.items()
                         if k.startswith("hist_") and k.endswith("_p99")}}


def check_syncless_intake(args, reps: int) -> dict:
    """K5 on the sync-less diet round's second call of a round: the exact
    freshness test of the [N, B] intake batch against the [N, S]
    staging buffer, unsorted in arrival order (captured from the 1M
    round), bit-equal to the plain version and timed."""
    import torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    from dispersy_tpu_torch.profiling import intake_unsorted_rows
    sg, sm, member, gt, ok = args
    n, s = sg.shape
    b = gt.shape[1]
    got = kernels.intake_checks(sg, sm, member, gt, ok)
    want = (intake.in_store_plain(sg, sm, member, gt),
            intake.dup_earlier_plain(member, gt, ok))
    fill = float((sg.view(torch.int32) != -1).float().mean())
    off = intake_unsorted_rows(types.SimpleNamespace(store_gt=sg,
                                                     store_member=sm))
    print(f"K5 on the staging: [{n}, {b}] batch against [{n}, {s}] "
          f"staging, {fill:.4f} of its slots live, {off} rows off the "
          f"search path, {int(got[0].sum())} hits", flush=True)
    if not bool(got[0].any()):
        fail("K5 on the staging: no batch entry is in the staging")
    row = timed_entry(
        "intake_checks_staging", "cuda", "dispersy_tpu_torch/csrc/intake.cu",
        "dispersy_tpu/ops/intake.py:80", list(got), list(want),
        lambda: kernels.intake_checks(sg, sm, member, gt, ok),
        lambda: (intake.in_store_plain(sg, sm, member, gt),
                 intake.dup_earlier_plain(member, gt, ok)),
        nbytes(sg, sm, member, gt, ok) + 2 * n * b, reps,
        ops=n * b * (s + b), kernel="intake_checks")
    row["_path"] = "syncless"
    return row


# ---- the soak path's kernels at the round's own inputs ----------------------

class SoakCapture:
    """While installed, keep the inputs of each kernel call shape that
    the soak round adds, as the last round made them: K1 on the
    signature channel and the four request channels, K4 at each
    channel's first serve compaction and at the pen rebuild, K11 on the
    pen and on the countersigners, K8 ``check`` on the signature inbox
    and on the batch's countersigners, K9 ``flip`` on the signature
    inbox; and the share of live pen slots and of slots that ask on each
    channel.  The op wrappers are patched where the engine looks them
    up; the calls themselves run unchanged."""

    def __init__(self, cfg):
        self.cfg, self.got, self.shares, self.channel = cfg, {}, {}, None

    def __enter__(self):
        from dispersy_tpu_torch import engine
        from dispersy_tpu_torch.ops import intake
        from dispersy_tpu_torch.ops import store as st
        from dispersy_tpu_torch.ops import timeline as tl
        cfg, got, n = self.cfg, self.got, self.cfg.n_peers
        d, s_sz = cfg.delay_inbox, cfg.sig_inbox
        # The intake batch's width: the pen, the sync pull, the push
        # inbox, the completion, the replies (budget proof_budget for
        # proofs and sequences, 1 for messages and identities).
        b = (d + cfg.response_budget + cfg.push_inbox + 1
             + 2 * d * cfg.proof_budget + 2 * d)
        self.saved = [(m, k, getattr(m, k)) for m, k in (
            (engine, "_deliver"), (engine, "_pen_channel"),
            (st, "rank_compact_many"), (intake, "seq_stored_max"),
            (intake, "identity_stored"), (tl, "check"),
            (tl, "check_many"), (intake, "flip_best"))]
        real = {k: f for _, k, f in self.saved}

        def deliver(cfg_, dst, cols, valid, n_peers, inbox_size, *a, **kw):
            if self.channel:
                got[f"deliver_{self.channel}"] = (dst, cols, valid, n_peers,
                                                  inbox_size)
            elif (len(cols) == 4 and dst.shape[0] == n
                  and inbox_size == s_sz):
                got["deliver_sig"] = (dst, cols, valid, n_peers, inbox_size)
            return real["_deliver"](cfg_, dst, cols, valid, n_peers,
                                    inbox_size, *a, **kw)

        def pen_channel(rt, stc, dl_src, want, *a):
            name = a[-1]
            self.channel, self.served = name, False
            self.shares["pen_live"] = float((dl_src >= 0).float().mean())
            self.shares[f"pen_asks_{name}"] = float(want.float().mean())
            try:
                return real["_pen_channel"](rt, stc, dl_src, want, *a)
            finally:
                self.channel = None

        def compact(cols_fills, slot, width):
            if self.channel and not self.served:
                got[f"compact_{self.channel}"] = (cols_fills, slot, width)
                self.served = True
            elif len(cols_fills) == 7 and width == d:
                got["compact_pen"] = (cols_fills, slot, width)
            return real["rank_compact_many"](cols_fills, slot, width)

        def seq_max(stc, member, meta):
            if member.shape[1] == d:
                got["seq_max_pen"] = (stc, member, meta)
            return real["seq_stored_max"](stc, member, meta)

        def ident(stc, member):
            if member.shape[1] == d:
                got["identity_pen"] = (stc, member)
            elif member.shape[1] == b:
                # The gate's call, then the countersigners' (kept).
                got["identity_aux"] = (stc, member)
            return real["identity_stored"](stc, member)

        def check(tab, member, meta, gt, founder, *a, **kw):
            q = member.shape[1]
            if q == s_sz and gt.shape[1] == s_sz:
                got["check_sig"] = (tab, member, meta, gt, founder)
            elif q == b and meta.shape[1] == b:
                got["check_aux"] = (tab, member, meta, gt, founder)
            return real["check"](tab, member, meta, gt, founder, *a, **kw)

        def check_many(tab, member, keys_perms, gt, founder):
            if member.shape[1] == b:
                got["check_many"] = (tab, member, keys_perms, gt, founder)
            return real["check_many"](tab, member, keys_perms, gt, founder)

        def flip(stc, q_meta, q_gt):
            if q_gt.shape[1] == s_sz:
                got["flip_sig"] = (stc, q_meta, q_gt)
            return real["flip_best"](stc, q_meta, q_gt)
        spies = {"_deliver": deliver, "_pen_channel": pen_channel,
                 "rank_compact_many": compact, "seq_stored_max": seq_max,
                 "identity_stored": ident, "check": check,
                 "check_many": check_many, "flip_best": flip}
        for m, k, _ in self.saved:
            setattr(m, k, spies[k])
        return self

    def __exit__(self, *exc):
        for m, k, f in self.saved:
            setattr(m, k, f)
        return False


def check_soak_kernels(cap: SoakCapture, reps: int) -> list:
    """Every new call shape of the soak round, on the inputs its last
    timed round gave it, held bit for bit against the plain version and
    timed: K1 on the signature and request channels (with ``torch.sort``
    of the packed key), K4 at each channel's serve compaction and at the
    pen rebuild, K11 ``seq_stored_max`` and ``identity_stored`` on the
    [N, D] pen and ``identity_stored`` on the batch's countersigners, K8
    ``check`` on the [N, S] signature inbox and on the [N, B] batch's
    countersigners, K9 ``flip`` on the signature inbox.  Prints what the
    inputs carry: the pen's live share, the share of pen slots that ask
    on each channel, each channel's request fill and the entries each
    compaction keeps."""
    import torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import PERM_PERMIT
    from dispersy_tpu_torch.ops import inbox, intake
    from dispersy_tpu_torch.ops import timeline as tl
    from dispersy_tpu_torch.profiling import k9_bytes, k11_cases
    got, cfg = cap.got, cap.cfg
    need = ([f"deliver_{c}" for c in ("sig", "proof", "seq", "mm", "id")]
            + [f"compact_{c}" for c in ("proof", "seq", "mm", "id", "pen")]
            + ["seq_max_pen", "identity_pen", "identity_aux", "check_many"])
    missing = [k for k in need if k not in got]
    if missing:
        fail(f"soak main path: no call captured for {missing}")
    x = inputs(cfg, SEED)
    rows, shares = [], dict(cap.shares)
    for key in need[:5]:
        dst, cols, valid, n_dst, q = got[key]
        inb, *rest = kernels.deliver(dst, cols, valid, n_dst, q)
        want = inbox.deliver_plain(dst, cols, valid, n_dst, q)
        shares[f"{key}_fill"] = float(valid.float().mean())
        rows.append(k1_row(x, key, dst, valid, cols, n_dst, q,
                           [*inb, *rest], [*want.inbox, *want[1:]], reps))
        if key == "deliver_sig":
            sig_inbox = inb             # (src, meta, payload, gt) [N, S]
    # The counterparty's checks run only for a double-signed meta that is
    # protected or dynamic, which the soak's is not: where the round made
    # none, they take the round's signature inbox, its intake table and
    # its batch, as such a meta would give them.
    tab, b_member, pairs, b_gt, founder = got["check_many"]
    sq_src, sq_meta, _, sq_gt = sig_inbox
    got.setdefault("check_sig", (tab, sq_src, sq_meta, sq_gt, founder))
    got.setdefault("check_aux", (tab, got["identity_aux"][1], pairs[2][0],
                                 b_gt, founder))
    got.setdefault("flip_sig", (got["seq_max_pen"][0], sq_meta, sq_gt))
    for key in need[5:10]:
        cols, slot, width = got[key]
        slot = slot.to(torch.int32)
        shares[f"{key}_kept"] = int(((slot >= 0) & (slot < width)).sum())
        rows.append(compact_row(
            "rank_compact_many_pen_rebuild" if key == "compact_pen"
            else f"rank_compact_many_serve_{key[8:]}", cols, slot, width,
            reps))
    for name, mode, (stc, member), meta in (
            ("store_probe_seq_max_pen", "seq_max", got["seq_max_pen"][:2],
             got["seq_max_pen"][2]),
            ("store_probe_identity_pen", "identity", got["identity_pen"],
             None),
            ("store_probe_identity_aux", "identity", got["identity_aux"],
             None)):
        if meta is None:
            meta = torch.zeros(member.shape, dtype=torch.uint8,
                               device=member.device)
        s_cols, q_cols, plain, moved, cmps, replaces = k11_cases(
            stc, member, member, meta, member, member)[mode]
        out = kernels.store_probe(mode, s_cols, q_cols)
        rows.append(timed_entry(
            name, "cuda", "dispersy_tpu_torch/csrc/probe.cu", replaces,
            [out], [plain()],
            lambda s_cols=s_cols, q_cols=q_cols, mode=mode:
            kernels.store_probe(mode, s_cols, q_cols), plain, moved, reps,
            ops=cmps * member.numel() * stc.gt.shape[1],
            kernel=f"store_probe_{mode}"))
    for name, key in (("timeline_check_sig", "check_sig"),
                      ("timeline_check_countersigner", "check_aux")):
        tab, member, meta, gt, founder = got[key]
        args = (tab, member, meta, gt, founder, PERM_PERMIT)
        n, a = tab.member.shape
        q = gt.shape[1]
        out = kernels.timeline_check(*args)
        rows.append(timed_entry(
            name, "cuda", "dispersy_tpu_torch/csrc/timeline.cu",
            "dispersy_tpu/ops/timeline.py:100", [out],
            [tl.check_plain(*args)],
            lambda args=args: kernels.timeline_check(*args),
            lambda args=args: tl.check_plain(*args),
            13 * n * a + nbytes(member, meta, gt, founder) + n * q, reps,
            kernel="timeline_check"))
    stc, q_meta, q_gt = got["flip_sig"]
    w_cols = (stc.meta == 0xF4, stc.payload, stc.gt, stc.aux)
    out = kernels.store_match("flip", w_cols, (q_meta, q_gt))
    rows.append(timed_entry(
        "store_match_flip_sig", "cuda", "dispersy_tpu_torch/csrc/match.cu",
        "dispersy_tpu/ops/intake.py:182", [out],
        [intake.flip_best_batch_plain(*w_cols, q_meta, q_gt)],
        lambda: kernels.store_match("flip", w_cols, (q_meta, q_gt)),
        lambda: intake.flip_best_batch_plain(*w_cols, q_meta, q_gt),
        k9_bytes("flip", w_cols, (q_meta, q_gt), out), reps,
        kernel="store_match_flip"))
    print("soak inputs: " + json.dumps(shares), flush=True)
    for row in rows:
        row["_path"] = "soak"
    return rows


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
    from dispersy_tpu_torch.metrics import snapshot
    from dispersy_tpu_torch.planes import FaultModel
    from dispersy_tpu_torch.profiling import (POST, SEQ_TEXT, bench_config,
                                              chaos_config, hardened_config,
                                              hardened_schedule,
                                              observed_config,
                                              observed_schedule,
                                              one_record_schedule,
                                              permissioned_config,
                                              permissioned_schedule,
                                              slice_config, soak_config,
                                              soak_roles, soak_schedule,
                                              syncless_config)
    from dispersy_tpu_torch.telemetry import flight_records

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
    obs_p = observed_config(PARITY_PEERS)
    obs_p = obs_p.replace(
        p_symmetric=0.3, faults=FaultModel(health_checks=True),
        telemetry=obs_p.telemetry.replace(flight_recorder=8))
    got = parity_phase(obs_p, SEED, OBS_PARITY_ROUNDS,
                       observed_schedule(PARITY_PEERS))
    snap = snapshot(got, obs_p)
    flights = len(flight_records(got, obs_p))
    covs = [snap[f"trace_cov_{k}"]
            for k in range(obs_p.trace.tracked_slots)]
    if not (min(covs) > 1 and flights and snap["trace_delivered_push"]):
        fail(f"observed parity run: tracking or the flight recorder idle "
             f"(coverage {covs}, {flights} flight records)")
    print(f"parity observed: coverage {covs}, flight records {flights}, "
          f"redundancy {snap['trace_redundancy']}", flush=True)
    got = parity_phase(syncless_config(PARITY_PEERS), SEED,
                       SYNCLESS_PARITY_ROUNDS,
                       one_record_schedule(PARITY_PEERS))
    if got.digest.numel() or not snapshot(got, syncless_config(
            PARITY_PEERS))["msgs_stored"]:
        fail("syncless parity run: a digest, or nothing stored")
    check_soak_parity(parity_phase(
        soak_config(PARITY_PEERS), SEED, SOAK_PARITY_ROUNDS,
        soak_schedule(PARITY_PEERS, SEED)))
    one = one_record_schedule(N_PEERS)
    mains = {
        "diet": main_phase(diet, "diet", DIET_PATH, SEED, DIET_WARMUP,
                           DIET_ROUNDS, one, (64, 2, 1, 64)),
        "observed": main_phase(observed_config(N_PEERS), "observed",
                               OBSERVED_PATH, SEED, DIET_WARMUP,
                               DIET_ROUNDS, observed_schedule(N_PEERS),
                               (64, 2, 1, 64)),
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
    d, o = mains["diet"], mains["observed"]
    print(f"observed vs diet (one run, {card}): ms per round "
          f"{o['ms_per_round']:.2f} vs {d['ms_per_round']:.2f} "
          f"(+{o['ms_per_round'] - d['ms_per_round']:.2f}), quiet "
          f"{o['ms_per_quiet_round']:.2f} vs {d['ms_per_quiet_round']:.2f}, "
          f"sync {o['ms_per_sync_round']:.2f} vs "
          f"{d['ms_per_sync_round']:.2f}; peak memory "
          f"{o['peak_mem_gib']:.3f} vs {d['peak_mem_gib']:.3f} GiB",
          flush=True)
    # The diet without sync, its K5 inputs of each round's staging call
    # kept (the last one checked and timed after the path).
    from dispersy_tpu_torch.ops import intake as intake_ops
    syncless, captured = syncless_config(N_PEERS), {}
    real_checks = intake_ops.intake_checks

    def spy(sg, *rest):
        if sg.shape[1] == syncless.store.staging:
            captured["args"] = (sg, *rest)
        return real_checks(sg, *rest)
    intake_ops.intake_checks = spy
    try:
        mains["syncless"] = main_phase(
            syncless, "syncless", SYNCLESS_PATH, SEED, SYNCLESS_WARMUP,
            SYNCLESS_ROUNDS, one, (64, 2, 1, 64))
    finally:
        intake_ops.intake_checks = real_checks
    if "args" not in captured:
        fail("syncless main path: K5 never ran against the staging")
    rows.append(check_syncless_intake(captured.pop("args"), REPS))
    # The soak community, its new kernel call shapes captured from its
    # rounds (the last timed round's are checked and timed after it).
    # The coverage that must grow is the founder's first grant's (its
    # clock claims 2 for its identity, 3 for this one).
    soak = soak_config(N_PEERS)
    with SoakCapture(soak) as cap:
        mains["soak"] = main_phase(
            soak, "soak", SOAK_PATH, SEED, SOAK_WARMUP, SOAK_ROUNDS,
            soak_schedule(N_PEERS, SEED),
            (soak.founder, 3, 0xF0, int(soak_roles(N_PEERS, SEED)[
                "grantees"][0])),
            channels=SOAK_CHANNELS)
    rows += check_soak_kernels(cap, REPS)
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

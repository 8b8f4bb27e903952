#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions; builds the CUDA kernels from ``dispersy_tpu_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, in parallel);
2. kernels: every kernel of the slice's path (K1-K5) on random inputs
   made with a numpy seed at the shapes the 1M-peer round gives it, held
   bit for bit against its plain PyTorch version on the card, and timed
   with CUDA events beside the plain version, the bytes bound and, where
   one PyTorch call does the same work, that call;
3. parity: a 4096-peer run of 20 rounds on the card through the kernels
   and on the CPU through the plain versions, equal on every state leaf
   after every round;
4. main path: the 1M-peer legacy-store round (``bench_config(1 << 20)``
   on the legacy ring) through the public entry points -- init_state,
   seed_overlay(8), one record authored by every 64th peer, 3 warm-up and
   10 timed rounds -- with every kernel's launch count read after it.

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
N_PEERS = 1 << 20              # the slice's full width: bench_config(1 << 20)
PARITY_PEERS, PARITY_ROUNDS = 4096, 20
WARMUP, ROUNDS = 3, 10
REPS = 20                      # timed launches per kernel (median)
SEED = 0


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


def cuda_times(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``reps`` launches of ``fn``, each between
    its own pair of CUDA events, after ``warmup`` launches."""
    import torch
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired tensors (integers and
    bools compared as int64); a shape or dtype mismatch fails."""
    import torch
    worst = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype {g.dtype}{list(g.shape)} vs "
                 f"{w.dtype}{list(w.shape)}")
        gi = g.view(torch.int32) if g.dtype == torch.uint32 else g
        wi = w.view(torch.int32) if w.dtype == torch.uint32 else w
        if g.dtype == torch.uint32:
            gi, wi = gi.long() & 0xFFFFFFFF, wi.long() & 0xFFFFFFFF
        diff = (gi.long() - wi.long()).abs()
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
    return worst


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---- phase 2: the kernels against their plain versions ---------------------

class Inputs:
    """Random inputs made with a numpy seed, on the card, and the shapes
    of the 1M-peer round (``cfg`` is the slice config)."""

    def __init__(self, cfg, seed: int):
        import numpy as np
        import torch
        self.np, self.torch = np, torch
        self.cfg = cfg
        self.rs = np.random.default_rng(seed)
        self.dev = torch.device("cuda")

    def u32(self, *shape, hi=1 << 32):
        a = self.rs.integers(0, hi, size=shape, dtype=self.np.uint64)
        return self.from_u32(a)

    def from_u32(self, a):
        a = self.np.asarray(a).astype(self.np.uint32).view(self.np.int32)
        return self.torch.from_numpy(a).to(self.dev).view(self.torch.uint32)

    def u8(self, *shape, hi=256):
        a = self.rs.integers(0, hi, size=shape).astype(self.np.uint8)
        return self.torch.from_numpy(a).to(self.dev)

    def flags(self, p, *shape):
        return self.torch.from_numpy(self.rs.random(shape) < p).to(self.dev)


def timed_entry(name, route, source, replaces, got, want, kernel_fn,
                plain_fn, bytes_moved, reps, ops=0, library_fn=None) -> dict:
    """Hold a kernel's outputs against its plain version's, then time
    kernel, plain version and library call; one kernels-JSON row."""
    err = max_abs_err(got, want)
    if err != 0:
        fail(f"kernel {name} disagrees with its plain version "
             f"(max abs err {err})")
    ms = cuda_times(kernel_fn, reps)
    plain_ms = cuda_times(plain_fn, reps)
    lib_ms = cuda_times(library_fn, reps) if library_fn else None
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms}
    print(f"kernel {name}: mismatches 0, kernel_ms {ms:.4f}, plain_ms "
          f"{plain_ms:.4f}, bound_ms {row['bound_ms']:.4f} "
          f"({row['bound_by']}), library_ms {lib_ms}", flush=True)
    return row


def check_deliver(x: Inputs, reps: int) -> list:
    """K1 at its call shapes: the push blast (E = N·F·C, five columns,
    Q = push_inbox) is timed; the request (seven columns with the [E, W]
    bloom), the tracker call (N = T, Q = tracker_inbox, so groups far
    above 32 take the block-select path) and the puncture hops (E = N·R,
    one column, Q = request_inbox) must agree too."""
    torch = x.torch
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    from dispersy_tpu_torch.u32 import narrow
    cfg, n = x.cfg, x.cfg.n_peers

    def case(e, n_dst, q, cols, p_valid, lo=-1):
        dst = torch.from_numpy(x.rs.integers(lo, n_dst + 1, size=e)
                               .astype(x.np.int32)).to(x.dev)
        valid = x.flags(p_valid, e)
        inb, inb_valid, dropped, slot = kernels.deliver(dst, cols, valid,
                                                        n_dst, q)
        want = inbox.deliver_plain(dst, cols, valid, n_dst, q)
        return (dst, valid, [*inb, inb_valid, dropped, slot],
                [*want.inbox, *want[1:]])

    e = n * cfg.forward_buffer * cfg.forward_fanout
    q = cfg.push_inbox
    cols = [x.u32(e), x.u32(e), x.u8(e, hi=8), x.u32(e), x.u32(e)]
    dst, valid, got, want = case(e, n, q, cols, 0.9)
    kept = int((got[-1] >= 0).sum())
    words = cfg.bloom_words
    req = [narrow(torch.arange(n, device=x.dev))] + [
        x.u32(n) for _ in range(5)] + [x.u32(n, words)]
    _, _, rg, rw = case(n, n, cfg.request_inbox, req, 0.9)
    trk = [narrow(torch.arange(n, device=x.dev)), x.u32(n)]
    _, _, tg, tw = case(n, cfg.n_trackers, cfg.tracker_inbox, trk, 0.08,
                        lo=0)
    r = cfg.request_inbox
    _, _, pg, pw = case(n * r, n, r, [x.u32(n * r, hi=n)], 0.7)
    row_b = 4 * 4 + 1
    moved = 5 * e + kept * row_b + n * q * (row_b + 1) + 4 * n + 4 * e
    ok = valid & (dst >= 0) & (dst < n)
    key = torch.where(ok, dst.long(), n) * e + torch.arange(e, device=x.dev)
    return [timed_entry(
        "deliver", "cuda", "dispersy_tpu_torch/csrc/deliver.cu",
        "dispersy_tpu/ops/inbox.py:79", got + rg + tg + pg,
        want + rw + tw + pw,
        lambda: kernels.deliver(dst, cols, valid, n, q),
        lambda: inbox.deliver_plain(dst, cols, valid, n, q), moved, reps,
        library_fn=lambda: torch.sort(key, stable=True))]


def check_bloom(x: Inputs, reps: int) -> list:
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


def store_inputs(x: Inputs):
    """Sorted rings with a random fill and a batch of the intake width
    (sync + push), keys drawn from a small range so that duplicates
    against the ring and inside the batch are common."""
    np = x.np
    from dispersy_tpu_torch.ops import store as st
    cfg, n, m = x.cfg, x.cfg.n_peers, x.cfg.msg_capacity
    b = cfg.response_budget + cfg.push_inbox
    g = x.rs.integers(1, 200, size=(n, m))
    mem = x.rs.integers(0, 6, size=(n, m))
    order = np.lexsort((mem, g), axis=1)
    live = np.arange(m)[None, :] < x.rs.integers(0, m + 1, size=n)[:, None]
    empty = 0xFFFFFFFF
    store = st.StoreCols(
        gt=x.from_u32(np.where(live, np.take_along_axis(g, order, 1), empty)),
        member=x.from_u32(np.where(live, np.take_along_axis(mem, order, 1),
                                   empty)),
        meta=x.torch.where(x.torch.from_numpy(live).to(x.dev),
                           x.u8(n, m, hi=4), 255).to(x.torch.uint8),
        payload=x.u32(n, m), aux=x.u32(n, m, hi=3), flags=x.u8(n, m, hi=2))
    batch = st.StoreCols(
        gt=x.u32(n, b, hi=200), member=x.u32(n, b, hi=6),
        meta=x.u8(n, b, hi=4), payload=x.u32(n, b), aux=x.u32(n, b, hi=3),
        flags=x.u8(n, b, hi=2))
    return store, batch


def check_store(x: Inputs, reps: int) -> list:
    """K3 with the fused compaction.  Its bytes: the ring's (gt, member)
    keys and the batch mask in full, the batch keys under the mask, the
    other four columns (10 B) of the records that survive only, and every
    output."""
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import store as st
    n, m = x.cfg.n_peers, x.cfg.msg_capacity
    store, batch = store_inputs(x)
    mask = x.flags(0.6, *batch.gt.shape)
    want = st.store_insert_plain(store, batch, mask)
    got = list(kernels.store_insert(store, batch, mask))
    kept = int((got[0].view(x.torch.int32) != -1).sum())
    moved = (8 * n * m + nbytes(mask) + 8 * int(mask.sum()) + 10 * kept
             + nbytes(*got))
    return [timed_entry(
        "store_insert", "cuda", "dispersy_tpu_torch/csrc/store.cu",
        "dispersy_tpu/ops/store.py:265", got,
        [*want.store, want.n_inserted, want.n_dropped, want.n_evicted],
        lambda: kernels.store_insert(store, batch, mask),
        lambda: st.store_insert_plain(store, batch, mask), moved, reps)]


def check_compact(x: Inputs, reps: int) -> list:
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


def check_intake(x: Inputs, reps: int) -> list:
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


KERNEL_CHECKS = (check_deliver, check_bloom, check_store, check_compact,
                 check_intake)


def kernel_phase(cfg, seed: int, reps: int) -> list:
    x = Inputs(cfg, seed)
    rows = []
    for check in KERNEL_CHECKS:
        rows += check(x, reps)
        x.torch.cuda.synchronize()
    return rows


# ---- phase 3: the card against the CPU at a small population --------------

def parity_phase(cfg, seed: int, rounds: int) -> None:
    import torch

    from dispersy_tpu_torch import engine, init_state
    from dispersy_tpu_torch.bridge import assert_states_equal

    def start(device):
        s = init_state(cfg, seed, device=device)
        s = engine.seed_overlay(s, cfg, 8)
        n = cfg.n_peers
        idx = torch.arange(n, device=s.device)
        return engine.create_messages(s, cfg, idx % 64 == 0, 1, idx)

    gpu, cpu = start("cuda"), start("cpu")
    assert_states_equal(gpu, cpu, "after create_messages")
    t0 = time.perf_counter()
    for rnd in range(rounds):
        gpu, cpu = engine.step(gpu, cfg), engine.step(cpu, cfg)
        assert_states_equal(gpu, cpu, f"{cfg.n_peers} peers, round {rnd}")
    print(f"parity: {cfg.n_peers} peers, {rounds} rounds, card == cpu on "
          f"every leaf after every round "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


# ---- phase 4: the main path at full width ----------------------------------

def main_phase(cfg, seed: int, warmup: int, rounds: int) -> dict:
    import torch

    from dispersy_tpu_torch import engine, init_state, kernels, metrics

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = init_state(cfg, seed, device="cuda")
    state = engine.seed_overlay(state, cfg, 8)
    n = cfg.n_peers
    idx = torch.arange(n, device=state.device)
    state = engine.create_messages(state, cfg, idx % 64 == 0, 1, idx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cov = []
    for _ in range(warmup):
        state = engine.step(state, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = time.perf_counter()
        state = engine.step(state, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - a)
        cov.append(float(engine.coverage(state, 64, 2, 1, 64)))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # What comes out: every leaf finite and of its schema shape, rings
    # sorted with holes last, the record spreading.
    for name, leaf in state.items():
        if name == "stats" or not isinstance(leaf, torch.Tensor):
            continue
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            fail(f"main path: leaf {name} holds non-finite values")
    if state.store_gt.shape != (n, cfg.msg_capacity):
        fail(f"main path: store_gt shape {tuple(state.store_gt.shape)}")
    g = state.store_gt.view(torch.int32).long() & 0xFFFFFFFF
    if bool((g[:, 1:] < g[:, :-1]).any()):
        fail("main path: a store ring is out of order")
    if not cov[-1] > cov[0]:
        fail(f"main path: coverage did not grow ({cov[0]} -> {cov[-1]})")
    snap = metrics.snapshot(state, cfg)
    if snap["walk_success"] == 0 or snap["msgs_stored"] == 0:
        fail(f"main path: nothing walked or stored: {snap}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched {missing}: {launches}")
    ms = statistics.median(times) * 1e3
    out = {"n_peers": n, "setup_s": setup_s, "warmup_rounds": warmup,
           "timed_rounds": rounds, "ms_per_round": ms,
           "rounds_per_s": 1e3 / ms, "round_ms": [x * 1e3 for x in times],
           "peak_mem_gib": peak / 2 ** 30, "coverage": cov,
           "walk_success_rate": snap["walk_success_rate"],
           "launches": launches, "launches_per_round": {
               k: v / (warmup + rounds) for k, v in launches.items()}}
    print("main: " + json.dumps(out), flush=True)
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
    from dispersy_tpu_torch.profiling import slice_config

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

    cfg = slice_config(N_PEERS)
    rows = kernel_phase(cfg, SEED, REPS)
    print(f"kernels checked ({time.perf_counter() - t_start:.1f} s)",
          flush=True)
    parity_phase(slice_config(PARITY_PEERS), SEED, PARITY_ROUNDS)
    main_out = main_phase(cfg, SEED, WARMUP, ROUNDS)
    for row in rows:
        row["launches"] = main_out["launches"][row["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Round times of ``chip_smoke.py``'s main paths, for two checkouts on
one card, in turns.

    python3 chip_ab.py OTHER_ROOT [PATH ...]

runs the six main paths of the first slices (or only the named ones, in
the order given: say ``chaos chaos_flat``; ``observed``, ``syncless``
and ``soak`` run only when named, on checkouts that have them) of the
checkout at
``OTHER_ROOT`` (say, the parent
commit unpacked with ``git archive`` into a git-ignored directory) and of
this one in the order other, this, this, other -- each run a process of
its own that imports its checkout's ``chip_smoke.py`` and builds its
kernels -- and prints one JSON line a run (``{"tag", "root", "paths":
{path: {"ms", "round_ms", "peak_gib", "allocator"}}}``), then for each
path the medians side by side and every run's round times, peak memory
and the caching allocator's cudaMalloc, cudaFree and retry counts in
the timed rounds (where the checkout's ``chip_smoke.py`` records them).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_paths(root: str, only: list) -> dict:
    """The six main paths of the checkout at ``root`` (already first on
    ``sys.path``), or those named in ``only`` in its order, as
    ``chip_smoke.main`` drives them, in one process."""
    import chip_smoke as cs
    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.profiling import (POST, SEQ_TEXT, bench_config,
                                              chaos_config, hardened_config,
                                              hardened_schedule,
                                              one_record_schedule,
                                              permissioned_config,
                                              permissioned_schedule,
                                              slice_config)
    if not Path(kernels.__file__).resolve().is_relative_to(Path(root)):
        raise SystemExit(f"imported {kernels.__file__}, not from {root}")
    kernels.build()
    n = cs.N_PEERS
    hard = hardened_config(n)
    one = one_record_schedule(n)
    mains = {
        "diet": (bench_config(n), cs.DIET_PATH, cs.DIET_WARMUP,
                 cs.DIET_ROUNDS, one, (64, 2, 1, 64), None),
        "legacy": (slice_config(n), cs.LEGACY_PATH, cs.WARMUP, cs.ROUNDS,
                   one, (64, 2, 1, 64), None),
        "permissioned": (permissioned_config(n), cs.PERM_PATH, cs.WARMUP,
                         cs.ROUNDS, permissioned_schedule(n, destroy=False),
                         (64, 2, POST, 64), None),
        "hardened": (hard, cs.HARD_PATH, cs.WARMUP, cs.ROUNDS,
                     hardened_schedule(n),
                     (hard.n_trackers, 4, SEQ_TEXT, hard.n_trackers + 1000),
                     lambda st: int((st.store_meta == SEQ_TEXT).sum())),
        "chaos": (chaos_config(n, 8, cs.CHAOS_BUDGET), cs.CHAOS_PATH,
                  cs.WARMUP, cs.ROUNDS, one, (64, 2, 1, 64), None),
        "chaos_flat": (chaos_config(n, 0), cs.CHAOS_FLAT_PATH, cs.WARMUP,
                       cs.ROUNDS, one, (64, 2, 1, 64), None)}
    if "observed" in only or "syncless" in only:
        from dispersy_tpu_torch.profiling import (observed_config,
                                                  observed_schedule,
                                                  syncless_config)
        mains["observed"] = (observed_config(n), cs.OBSERVED_PATH,
                             cs.DIET_WARMUP, cs.DIET_ROUNDS,
                             observed_schedule(n), (64, 2, 1, 64), None)
        mains["syncless"] = (syncless_config(n), cs.SYNCLESS_PATH,
                             cs.SYNCLESS_WARMUP, cs.SYNCLESS_ROUNDS, one,
                             (64, 2, 1, 64), None)
    channels = {}
    if "soak" in only:
        from dispersy_tpu_torch.profiling import (soak_config, soak_roles,
                                                  soak_schedule)
        soak = soak_config(n)
        mains["soak"] = (soak, cs.SOAK_PATH, cs.SOAK_WARMUP, cs.SOAK_ROUNDS,
                         soak_schedule(n, cs.SEED),
                         (soak.founder, 3, 0xF0,
                          int(soak_roles(n, cs.SEED)["grantees"][0])),
                         None)
        channels["soak"] = cs.SOAK_CHANNELS
    out = {}
    for path in only or mains:
        cfg, needed, warmup, rounds, creates, record, spread = mains[path]
        r = cs.main_phase(cfg, path, needed, cs.SEED, warmup, rounds,
                          creates, record, spread=spread,
                          **({"channels": channels[path]}
                             if path in channels else {}))
        out[path] = {"ms": r["ms_per_round"], "round_ms": r["round_ms"],
                     "peak_gib": r["peak_mem_gib"],
                     "allocator": r.get("allocator_timed")}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--run"]:
        root, tag, only = sys.argv[2], sys.argv[3], sys.argv[4:]
        sys.path.insert(0, root)
        print("AB " + json.dumps({"tag": tag, "root": root,
                                  "paths": run_paths(root, only)}),
              flush=True)
        return 0
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other, only = str(Path(sys.argv[1]).resolve()), sys.argv[2:]
    runs = []
    for tag, root in (("other", other), ("this", str(HERE)),
                      ("this", str(HERE)), ("other", other)):
        proc = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                               "--run", root, tag, *only], cwd=root,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[0][3:]))
        print(lines[0][3:], flush=True)
    for path in runs[0]["paths"]:
        print(path, " ".join(f"{r['tag']} {r['paths'][path]['ms']:.2f}"
                             for r in runs), flush=True)
        for r in runs:
            got = r["paths"][path]
            print(f"  {r['tag']:5s} rounds " + " ".join(
                f"{t:.2f}" for t in got["round_ms"])
                + f"  peak {got['peak_gib']:.6f} GiB"
                + (f"  allocator {got['allocator']}" if got.get("allocator")
                   else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

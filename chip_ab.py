#!/usr/bin/env python3
"""Round times of ``chip_smoke.py``'s six main paths, for two checkouts on
one card, in turns.

    python3 chip_ab.py OTHER_ROOT

runs the main paths of the checkout at ``OTHER_ROOT`` (say, the parent
commit unpacked with ``git archive`` into a git-ignored directory) and of
this one in the order other, this, this, other -- each run a process of
its own that imports its checkout's ``chip_smoke.py`` and builds its
kernels -- and prints one JSON line a run (``{"tag", "root", "paths":
{path: {"ms", "round_ms", "peak_gib"}}}``), then for each path the
medians side by side and every run's round times and peak memory.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_paths(root: str) -> dict:
    """The six main paths of the checkout at ``root`` (already first on
    ``sys.path``), as ``chip_smoke.main`` drives them."""
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
    out = {}
    for path, (cfg, needed, warmup, rounds, creates, record,
               spread) in mains.items():
        r = cs.main_phase(cfg, path, needed, cs.SEED, warmup, rounds,
                          creates, record, spread=spread)
        out[path] = {"ms": r["ms_per_round"], "round_ms": r["round_ms"],
                     "peak_gib": r["peak_mem_gib"]}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--run"]:
        root, tag = sys.argv[2], sys.argv[3]
        sys.path.insert(0, root)
        print("AB " + json.dumps({"tag": tag, "root": root,
                                  "paths": run_paths(root)}), flush=True)
        return 0
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    runs = []
    for tag, root in (("other", other), ("this", str(HERE)),
                      ("this", str(HERE)), ("other", other)):
        proc = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                               "--run", root, tag], cwd=root,
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
                + f"  peak {got['peak_gib']:.4f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K5's in-batch dedup in several forms on one card, each form built
from ``dispersy_tpu_torch/csrc/intake.cu`` by replacing its dedup step.

    python3 tools/k5_dedup_forms.py

Forms:

- ``hash32`` -- the source as it is: ``__match_any_sync`` on a 32-bit
  hash of (gt, member), each candidate confirmed by a shuffle of its key;
- ``match64`` -- ``__match_any_sync`` on the 64-bit key itself;
- ``shuffle`` -- a loop over the earlier lanes of the chunk, two
  shuffles a step;
- ``none`` -- no dedup at all (its ``dup_earlier`` answers are wrong): the
  floor the rest of the kernel sets;
- ``hash32_rg1`` / ``hash32_rg4`` -- the kept form with 1 or 4 rows a
  group in both modes (the source takes 1 with a ring, 4 without).

Each form is built with the kernels' nvcc flags into ``build/k5_forms/``
and loaded in place of the intake library; every form but ``none`` is
held bit-equal to the plain versions, then each of
``profiling.compact_cases``' K5 cases (the legacy intake on sorted and on
reversed rings, ``dup_earlier`` at the diet shape) is timed with CUDA
events (median of 20), the forms in turn, forward then backward.  Prints
the card line and one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KEPT_FROM = "      // The earlier ok lanes of the chunk whose key hashes alike"
KEPT_TO = "      if (!e.in) continue;\n"
ROWS = "  return STORE ? 1 : RPG;"

DEDUP = {
    "match64": """      const unsigned oks = __ballot_sync(dk::FULL_MASK, e.ok);
      const unsigned same =
          __match_any_sync(dk::FULL_MASK, key_of(e.gt, e.mem));
      bool d = (same & oks & gmask & below) != 0;
""",
    "shuffle": """      const unsigned oks = __ballot_sync(dk::FULL_MASK, e.ok);
      bool d = false;
      const int span = min(G, b - k0);
#pragma unroll
      for (int s = 1; s < G; ++s) {
        if (s >= span) break;
        const uint32_t m2 = __shfl_up_sync(dk::FULL_MASK, e.mem, s, G);
        const uint32_t g2 = __shfl_up_sync(dk::FULL_MASK, e.gt, s, G);
        d |= gl >= s && ((oks >> ((lane - s) & 31)) & 1u) &&
             m2 == e.mem && g2 == e.gt;
      }
""",
    "none": """      bool d = false;
""",
}


def form_source(src: str, form: str) -> str:
    if form.startswith("hash32"):
        rg = {"hash32": None, "hash32_rg1": "1", "hash32_rg4": "RPG"}[form]
        if rg is None:
            return src
        assert ROWS in src
        return src.replace(ROWS, f"  return {rg};")
    a = src.index(KEPT_FROM)
    b = src.index(KEPT_TO, a)
    return src[:a] + DEDUP[form] + src[b:]


def main() -> int:
    import torch

    from dispersy_tpu_torch import kernels, profiling
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = ROOT / "build" / "k5_forms"
    out.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / "intake.cu").read_text()
    forms = ["hash32", "match64", "shuffle", "none", "hash32_rg1",
             "hash32_rg4"]
    procs = {}
    for f in forms:
        (out / f"{f}.cu").write_text(form_source(src, f))
        procs[f] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(out / f"lib{f}.so"), str(out / f"{f}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for f, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            print(f"nvcc failed on {f}:\n{text}", file=sys.stderr)
            return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cases = {k: c for k, c in profiling.compact_cases().items()
             if c[4] in ("intake_checks", "dup_earlier")}
    libs = {f: ctypes.CDLL(str(out / f"lib{f}.so")) for f in forms}
    ms: dict = {}
    for f in forms + forms[::-1]:
        kernels._LIBS["intake"] = libs[f]
        for name, (kernel, plain, _, _, _) in cases.items():
            if f != "none" and not profiling._same(kernel(), plain()):
                print(f"{f} {name}: differs from the plain version",
                      file=sys.stderr)
                return 1
            ms.setdefault(f, {}).setdefault(name, []).append(
                profiling.cuda_ms(kernel, 20))
        torch.cuda.synchronize()
    print(card)
    print(json.dumps({"card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

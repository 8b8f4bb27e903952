#!/usr/bin/env python3
"""Time K12 (``dispersy_tpu_torch/csrc/ragged.cu``) in several forms on
one card, each a copy of the source with its bucket stages' passes
edited.

    python3 tools/k12_forms.py

Forms:

- ``as built`` -- the source as it is;
- ``EPT 4`` / ``EPT 8`` / ``EPT 16`` -- 4, 8 or 16 edges a thread of an
  edge pass (the form equal to the source's own count is skipped);
- ``dst with valid`` -- each pass loads an edge's destination with its
  valid flag, not after it (one round trip, all destinations read);
- ``plain hist atomics`` -- the hist pass adds each edge with its own
  atomics, without the warp's aggregation.

A form whose edit no longer matches the source stops the script.

Each form is built with the kernels' nvcc flags (and ``-Xptxas -v``,
for registers and spill bytes) into ``build/k12_forms/`` and loaded in
place of the ragged library, held bit-equal to the plain version, then
K12's capped cases of ``profiling.delivery_cases`` (the chaos push blast
at the round's budget and at one that binds nowhere) are timed with
CUDA events (median of 20), the forms in turn, the built form first and
last.  Prints the card line and one JSON line.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LOAD_AFTER = ("    const int x = v[u] ? dst[edge_at(sp, u)] : -1;\n"
              "    d[u] = x >= 0 && x < n ? x : -1;")
LOAD_WITH = ("    const long long i = edge_at(sp, u);\n"
             "    const int x = i < sp.hi ? dst[i] : -1;\n"
             "    d[u] = v[u] && x >= 0 && x < n ? x : -1;")
HIST_ADDS = re.compile(r"    warp_add\((hist|hcs) (.*?), ok\);", re.S)


def form_source(src: str, name: str) -> str:
    """``src`` edited into form ``name``; raises where the edit matches
    nothing (the source moved on from the text it edits)."""
    if name == "as built":
        return src
    if name.startswith("EPT "):
        text, hits = re.subn(r"constexpr int EPT = \d+;",
                             f"constexpr int EPT = {name[4:]};", src)
    elif name == "dst with valid":
        hits = src.count(LOAD_AFTER)
        text = src.replace(LOAD_AFTER, LOAD_WITH)
    else:
        text, hits = HIST_ADDS.subn(r"    if (ok) atomicAdd(\1 \2, 1);",
                                    src)
    if not hits:
        raise ValueError(f"form {name!r}: its edit matches nothing in "
                         "ragged.cu")
    return text


FORMS = ("as built", "EPT 4", "EPT 8", "EPT 16", "dst with valid",
         "plain hist atomics")


def main() -> int:
    import torch

    from dispersy_tpu_torch import kernels, profiling
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = ROOT / "build" / "k12_forms"
    src = (kernels.CSRC / "ragged.cu").read_text()
    forms = [name for name in FORMS
             if name == "as built" or form_source(src, name) != src]
    procs = {}
    for i, name in enumerate(forms):
        d = out / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "ragged.cu").write_text(form_source(src, name))
        procs[name] = (d, subprocess.Popen(
            [kernels._nvcc(), "-Xptxas", "-v", *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC), "-o", str(d / "libragged.so"),
             str(d / "ragged.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    registers, libs = {}, {}
    for name, (d, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed on form {name!r}:\n{text}", file=sys.stderr)
            return 1
        registers[name] = {
            k: [int(r), int(sp)] for k, sp, r in re.findall(
                r"(rg_\w+?_kernel).*?(\d+) bytes spill stores.*?Used (\d+) "
                r"registers", text, re.S)}
        libs[name] = ctypes.CDLL(str(d / "libragged.so"))
    cases = {k: c for k, c in profiling.delivery_cases().items()
             if k.startswith("ragged_push")}
    ms: dict = {}
    for name in [*forms, "as built"]:
        kernels._LIBS["ragged"] = libs[name]
        for case, (kernel, plain, _) in cases.items():
            if not profiling._same(kernel(), plain()):
                print(f"form {name!r}, {case}: differs from the plain "
                      "version", file=sys.stderr)
                return 1
            ms.setdefault(name, {}).setdefault(case, []).append(
                profiling.cuda_ms(kernel, 20))
        torch.cuda.synchronize()
    card = profiling.card_name()
    print(card)
    print(json.dumps({"card": card, "ms": ms, "registers": registers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K8 (``dispersy_tpu_torch/csrc/timeline.cu``) in several forms on
one card, each a copy of the source with its queries a lane (``QL``) or
its launch bounds edited.

    python3 tools/k8_forms.py

Forms (queries a lane, blocks a multiprocessor the launch bounds ask
for, 0 for none; None keeps the source's own):

- ``as built`` -- the source as it is;
- ``QL 1`` / ``QL 3`` -- one or three queries a lane;
- ``no block minimum`` / ``min 4 blocks`` -- other launch bounds.

Each form is built with the kernels' nvcc flags (and ``-Xptxas -v``, for
its registers and spill bytes) into ``build/k8_forms/`` and loaded in
place of the timeline library, held bit-equal to the plain versions,
then K8's cases of ``profiling.timeline_stage_cases`` are timed with
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

FORMS = {"as built": (None, None), "QL 1": (1, None), "QL 3": (3, None),
         "no block minimum": (None, 0), "min 4 blocks": (None, 4)}


def form_source(src: str, ql, blocks) -> str:
    text = src
    if ql is not None:
        text = re.sub(r"constexpr int QL = \d+;", f"constexpr int QL = {ql};",
                      text)
    if blocks is not None:
        text = text.replace(
            "__launch_bounds__(THREADS, MIN_BLOCKS)",
            f"__launch_bounds__(THREADS, {blocks})" if blocks
            else "__launch_bounds__(THREADS)")
    if (ql, blocks) != (None, None) and text == src:
        raise RuntimeError(f"form {(ql, blocks)} changed nothing")
    return text


def main() -> int:
    import torch

    from dispersy_tpu_torch import kernels, profiling
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = ROOT / "build" / "k8_forms"
    src = (kernels.CSRC / "timeline.cu").read_text()
    procs = {}
    for i, (name, (ql, blocks)) in enumerate(FORMS.items()):
        d = out / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "timeline.cu").write_text(form_source(src, ql, blocks))
        procs[name] = (d, subprocess.Popen(
            [kernels._nvcc(), "-Xptxas", "-v", *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC), "-o", str(d / "libtimeline.so"),
             str(d / "timeline.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    registers, libs = {}, {}
    for name, (d, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed on form {name!r}:\n{text}", file=sys.stderr)
            return 1
        registers[name] = {
            f"A {a}, pairs {p}, metas {m}": [int(r), int(sp)]
            for a, p, m, sp, r in re.findall(
                r"kernelILi(\d+)ELi(\d+)ELi(\d+)E.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", text, re.S)
            if a == "8" and (p, m) in (("1", "0"), ("3", "0"), ("0", "3"))}
        libs[name] = ctypes.CDLL(str(d / "libtimeline.so"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cases = {k: c for k, c in profiling.timeline_stage_cases().items()
             if c[4] != "store_stage"}
    ms: dict = {}
    for name in [*FORMS, "as built"]:
        kernels._LIBS["timeline"] = libs[name]
        for case, (kernel, plain, _, _, _) in cases.items():
            if not profiling._same(kernel(), plain()):
                print(f"form {name!r}, {case}: differs from the plain "
                      "version", file=sys.stderr)
                return 1
            ms.setdefault(name, {}).setdefault(case, []).append(
                profiling.cuda_ms(kernel, 20))
        torch.cuda.synchronize()
    print(card)
    print(json.dumps({"card": card, "ms": ms, "registers": registers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

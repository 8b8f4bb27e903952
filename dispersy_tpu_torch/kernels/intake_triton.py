"""K5: the intake checks, as a Triton kernel (the port's only one).

Replaces ``in_store`` (dispersy_tpu/ops/intake.py:80) and ``dup_earlier``
(:137), whose TPU form is a broadcast compare-reduce over [N, B, M] (the
CPU takes a chunked ``fori_loop`` above 2^28 elements,
``intake.py:69-76``).  With ``HAS_STORE`` off the kernel computes
``dup_earlier`` alone and reads no store: the byte-diet round's
freshness test is a digest query (K2), not a ring compare.

Bound on the H100: bytes.  The function reads two [N, M] store columns
and two [N, B] batch columns plus the mask, and writes two bool [N, B]
results; the N·B·(M + B) equality tests are cheap integer work beside
that.

Design.  One program per block of ``ROWS`` rows.  It loads the rows'
store keys [ROWS, M] and batch keys [ROWS, B] once, forms the two
compare tensors in registers -- batch against store for ``in_store``,
batch against the earlier batch entries for ``dup_earlier`` -- and
reduces each over its last axis.  Only equality is tested, so the u32
columns are read through their int32 views.

``triton`` is imported inside :func:`launch`: the CPU tests import this
package on machines without it.
"""

from __future__ import annotations

import os

import torch

_KERNEL: dict = {}   # the jitted kernel, made on first launch


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _kernel():
    if "k" in _KERNEL:
        return _KERNEL["k"]
    from dispersy_tpu_torch.kernels import BUILD
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def dk_intake_kernel(sg_ptr, sm_ptr, mem_ptr, gt_ptr, ok_ptr, ins_ptr,
                         dup_ptr, n, M: tl.constexpr, B: tl.constexpr,
                         MP: tl.constexpr, BP: tl.constexpr,
                         ROWS: tl.constexpr, HAS_STORE: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        r2 = rows.to(tl.int64)[:, None]
        bi = tl.arange(0, BP)
        bmask = (rows[:, None] < n) & (bi[None, :] < B)          # [R, BP]
        g = tl.load(gt_ptr + r2 * B + bi[None, :], mask=bmask, other=0)
        mb = tl.load(mem_ptr + r2 * B + bi[None, :], mask=bmask, other=0)
        ok = tl.load(ok_ptr + r2 * B + bi[None, :], mask=bmask, other=0)
        out = r2 * B + bi[None, :]
        if HAS_STORE:
            mi = tl.arange(0, MP)
            smask = (rows[:, None] < n) & (mi[None, :] < M)      # [R, MP]
            sg = tl.load(sg_ptr + r2 * M + mi[None, :], mask=smask, other=0)
            sm = tl.load(sm_ptr + r2 * M + mi[None, :], mask=smask, other=0)
            hit = ((sg[:, None, :] == g[:, :, None])
                   & (sm[:, None, :] == mb[:, :, None])
                   & smask[:, None, :])                          # [R, BP, MP]
            in_store = tl.max(hit.to(tl.int32), axis=2)
            tl.store(ins_ptr + out, in_store.to(tl.int8), mask=bmask)
        earlier = bi[None, :] < bi[:, None]                      # [b, j]: j < b
        same = ((g[:, None, :] == g[:, :, None])
                & (mb[:, None, :] == mb[:, :, None])
                & (ok[:, None, :] != 0) & bmask[:, None, :]
                & earlier[None, :, :])                           # [R, BP, BP]
        dup = tl.max(same.to(tl.int32), axis=2)
        tl.store(dup_ptr + out, dup.to(tl.int8), mask=bmask)

    _KERNEL["k"] = dk_intake_kernel
    return dk_intake_kernel


def launch(store_gt, store_member, member, gt, ok):
    """``(in_store, dup_earlier)``, each bool [N, B]; with ``store_gt``
    None, ``dup_earlier`` alone.  The caller
    (:func:`dispersy_tpu_torch.kernels.intake_checks` or ``dup_earlier``)
    has checked the inputs."""
    n, b = gt.shape
    has_store = store_gt is not None
    m = store_gt.shape[1] if has_store else 0
    mp, bp = _pow2(m), _pow2(b)
    rows = max(1, min(16, 8192 // (bp * max(mp, bp))))
    rows = 1 << (rows.bit_length() - 1)
    dup = torch.empty((n, b), dtype=torch.bool, device=gt.device)
    in_store = (torch.empty((n, b), dtype=torch.bool, device=gt.device)
                if has_store else dup)
    sg, sm = ((store_gt, store_member) if has_store else (gt, member))
    grid = ((n + rows - 1) // rows,)
    _kernel()[grid](
        sg.view(torch.int32), sm.view(torch.int32),
        member.view(torch.int32), gt.view(torch.int32),
        ok.view(torch.int8), in_store.view(torch.int8), dup.view(torch.int8),
        n, M=max(m, 1), B=b, MP=mp, BP=bp, ROWS=rows, HAS_STORE=has_store,
        num_warps=4)
    return (in_store, dup) if has_store else dup

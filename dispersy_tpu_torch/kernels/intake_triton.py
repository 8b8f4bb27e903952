"""K5: the intake checks, and K9: the Timeline's store replays, as Triton
kernels.

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

K9 ``store_match`` replaces ``flip_best_batch`` (intake.py:182;
``flip_best`` :163 is its store-side view), ``undo_marked`` (:217),
``stored_meta_of`` (:293) and ``undo_hits_store`` (:244) -- the same
broadcast compare-reduce on the TPU, over the row's W store (or batch)
entries for each of its Q queries.  One kernel with a ``MODE``
constexpr: a flag per entry (the flip mask, the undo metas, the user
metas, the batch's accepted undos), an equality on one key and, on the
second key, an unsigned ``<=`` (``FLIP``) or an equality; then the max
of ``gt * 2 | (aux & 1)`` (``FLIP``), any (``UNDO_MARKED``,
``UNDO_HITS``) or the min of the meta, else 0xFFFF (``META_OF``).
``UNDO_HITS`` is the transposed view: its queries are the store rows
and its entries the batch.  Bound on the H100: bytes (three or four
[N, W] columns and two [N, Q] columns read, one [N, Q] written); the
design is K5's, one program per block of rows with the [ROWS, Q, W]
compare in registers.  Unsigned order and the wrapping u32 key are
taken on int32 bits with the sign bit flipped, so no u32 arithmetic is
needed in the kernel.

K11 ``store_probe`` replaces the hardened community's three store
probes -- ``conflict`` (intake.py:104), ``identity_stored`` (:269) and
``seq_stored_max`` (:325) -- the same broadcast compare-reduce on the
TPU, of each of the row's B batch entries against its M store slots.
One kernel with a ``MODE`` constexpr: ``CONFLICT`` reads five store
columns and five query columns and answers any(live, same (member, gt),
different (meta, payload, aux)); ``IDENTITY`` any(meta ==
dispersy-identity, same member) with no gt test; ``SEQ_MAX`` the max of
the aux over the live rows of the entry's (member, meta), else 0, in
unsigned order (sign bit flipped, as ``FLIP``).  The u8 metas are
widened to int32 in registers on both sides.  It is a kernel of its
own, not more K9 modes: ``conflict`` needs five columns on each side,
K9 has three and two.  Bound on the H100: bytes (two to five [N, M]
columns and one to five [N, B] columns read, one [N, B] written).

``triton`` is imported inside :func:`launch`, :func:`launch_match` and
:func:`launch_probe`: the CPU tests import this package on machines
without it.
"""

from __future__ import annotations

import os

import torch

_KERNEL: dict = {}   # the jitted kernels, made on first launch
# K9 modes.
FLIP, UNDO_MARKED, META_OF, UNDO_HITS = 0, 1, 2, 3
MODES = {"flip": FLIP, "undo_marked": UNDO_MARKED, "meta_of": META_OF,
         "undo_hits": UNDO_HITS}
# K11 modes.
CONFLICT, IDENTITY, SEQ_MAX = 0, 1, 2
PROBE_MODES = {"conflict": CONFLICT, "identity": IDENTITY, "seq_max": SEQ_MAX}


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


def _match_kernel():
    if "match" in _KERNEL:
        return _KERNEL["match"]
    from dispersy_tpu_torch.kernels import BUILD
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def dk_store_match_kernel(wf_ptr, w1_ptr, w2_ptr, wv_ptr, q1_ptr, q2_ptr,
                              out_ptr, n, W: tl.constexpr, Q: tl.constexpr,
                              WP: tl.constexpr, QP: tl.constexpr,
                              ROWS: tl.constexpr, MODE: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        r2 = rows.to(tl.int64)[:, None]
        qi = tl.arange(0, QP)
        wi = tl.arange(0, WP)
        qmask = (rows[:, None] < n) & (qi[None, :] < Q)          # [R, QP]
        wmask = (rows[:, None] < n) & (wi[None, :] < W)          # [R, WP]
        q1 = tl.load(q1_ptr + r2 * Q + qi[None, :], mask=qmask, other=0)
        q2 = tl.load(q2_ptr + r2 * Q + qi[None, :], mask=qmask, other=0)
        wat = r2 * W + wi[None, :]
        wf = tl.load(wf_ptr + wat, mask=wmask, other=0).to(tl.int32)
        w1 = tl.load(w1_ptr + wat, mask=wmask, other=0)
        w2 = tl.load(w2_ptr + wat, mask=wmask, other=0)
        sign = -2147483648
        if MODE == 1:           # UNDO_MARKED: dispersy-undo-own / -other
            ok = (wf == 0xF2) | (wf == 0xF3)
        elif MODE == 2:         # META_OF: user records
            ok = wf < 32
        else:                   # FLIP, UNDO_HITS: the flag itself
            ok = wf != 0
        ok = ok & wmask
        hit = ok[:, None, :] & (w1[:, None, :] == q1[:, :, None])
        if MODE == 0:           # gt <= q_gt, unsigned
            hit = hit & ((w2 ^ sign)[:, None, :] <= (q2 ^ sign)[:, :, None])
        else:
            hit = hit & (w2[:, None, :] == q2[:, :, None])
        out = r2 * Q + qi[None, :]
        if MODE == 0:
            wv = tl.load(wv_ptr + wat, mask=wmask, other=0)
            key = ((w2 << 1) | (wv & 1)) ^ sign   # u32 order on int32
            best = tl.max(tl.where(hit, key[:, None, :], sign), axis=2)
            tl.store(out_ptr + out, best ^ sign, mask=qmask)
        elif MODE == 2:
            best = tl.min(tl.where(hit, wf[:, None, :], 0xFFFF), axis=2)
            tl.store(out_ptr + out, best, mask=qmask)
        else:
            anyhit = tl.max(hit.to(tl.int32), axis=2)
            tl.store(out_ptr + out, anyhit.to(tl.int8), mask=qmask)

    _KERNEL["match"] = dk_store_match_kernel
    return dk_store_match_kernel


def launch_match(mode: int, flag, w1, w2, wv, q1, q2):
    """K9 in ``mode``: ``flag`` u8 [N, W] (a bool mask's bytes or the
    meta column), ``w1``/``w2``/``wv`` u32 [N, W], ``q1``/``q2`` u32
    [N, Q] (``wv`` is read by ``FLIP`` only).  Returns u32 [N, Q] for
    ``FLIP`` and ``META_OF``, bool [N, Q] otherwise.  The caller
    (:func:`dispersy_tpu_torch.kernels.store_match`) has checked the
    inputs."""
    n, q = q1.shape
    w = w1.shape[1]
    wp, qp = _pow2(w), _pow2(q)
    rows = max(1, min(16, 8192 // (qp * wp)))
    rows = 1 << (rows.bit_length() - 1)
    if mode in (FLIP, META_OF):
        out = torch.empty((n, q), dtype=torch.uint32, device=q1.device)
        out_bits = out.view(torch.int32)
    else:
        out = torch.empty((n, q), dtype=torch.bool, device=q1.device)
        out_bits = out.view(torch.int8)
    grid = ((n + rows - 1) // rows,)
    _match_kernel()[grid](
        flag, w1.view(torch.int32), w2.view(torch.int32),
        wv.view(torch.int32), q1.view(torch.int32), q2.view(torch.int32),
        out_bits, n, W=w, Q=q, WP=wp, QP=qp, ROWS=rows, MODE=mode,
        num_warps=4)
    return out


def _probe_kernel():
    if "probe" in _KERNEL:
        return _KERNEL["probe"]
    from dispersy_tpu_torch.kernels import BUILD
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def dk_store_probe_kernel(sg_ptr, sm_ptr, st_ptr, sp_ptr, sa_ptr,
                              qm_ptr, qg_ptr, qt_ptr, qp_ptr, qa_ptr,
                              out_ptr, n, M: tl.constexpr, B: tl.constexpr,
                              MP: tl.constexpr, BP: tl.constexpr,
                              ROWS: tl.constexpr, MODE: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        r2 = rows.to(tl.int64)[:, None]
        bi = tl.arange(0, BP)
        mi = tl.arange(0, MP)
        bmask = (rows[:, None] < n) & (bi[None, :] < B)          # [R, BP]
        smask = (rows[:, None] < n) & (mi[None, :] < M)          # [R, MP]
        sat = r2 * M + mi[None, :]
        qat = r2 * B + bi[None, :]
        out = qat
        sign = -2147483648
        # Every mode compares the member.
        sm = tl.load(sm_ptr + sat, mask=smask, other=0)
        qm = tl.load(qm_ptr + qat, mask=bmask, other=0)
        st = tl.load(st_ptr + sat, mask=smask, other=0).to(tl.int32)
        hit = (sm[:, None, :] == qm[:, :, None]) & smask[:, None, :]
        if MODE == 1:           # IDENTITY: a dispersy-identity row
            hit = hit & (st == 0xF6)[:, None, :]
            anyhit = tl.max(hit.to(tl.int32), axis=2)
            tl.store(out_ptr + out, anyhit.to(tl.int8), mask=bmask)
        else:
            sg = tl.load(sg_ptr + sat, mask=smask, other=0)
            sa = tl.load(sa_ptr + sat, mask=smask, other=0)
            hit = hit & (sg != -1)[:, None, :]                   # live rows
            if MODE == 0:       # CONFLICT
                qg = tl.load(qg_ptr + qat, mask=bmask, other=0)
                qt = tl.load(qt_ptr + qat, mask=bmask, other=0).to(tl.int32)
                qp = tl.load(qp_ptr + qat, mask=bmask, other=0)
                qa = tl.load(qa_ptr + qat, mask=bmask, other=0)
                sp = tl.load(sp_ptr + sat, mask=smask, other=0)
                hit = hit & (sg[:, None, :] == qg[:, :, None])
                diff = ((st[:, None, :] != qt[:, :, None])
                        | (sp[:, None, :] != qp[:, :, None])
                        | (sa[:, None, :] != qa[:, :, None]))
                anyhit = tl.max((hit & diff).to(tl.int32), axis=2)
                tl.store(out_ptr + out, anyhit.to(tl.int8), mask=bmask)
            else:               # SEQ_MAX, unsigned order on int32 bits
                qt = tl.load(qt_ptr + qat, mask=bmask, other=0).to(tl.int32)
                hit = hit & (st[:, None, :] == qt[:, :, None])
                key = sa ^ sign
                best = tl.max(tl.where(hit, key[:, None, :], sign), axis=2)
                tl.store(out_ptr + out, best ^ sign, mask=bmask)

    _KERNEL["probe"] = dk_store_probe_kernel
    return dk_store_probe_kernel


def launch_probe(mode: int, s_gt, s_member, s_meta, s_payload, s_aux,
                 q_member, q_gt, q_meta, q_payload, q_aux):
    """K11 in ``mode``: the store's u32 gt / member / payload / aux and u8
    meta columns [N, M], the batch's u32 member / gt / payload / aux and
    u8 meta columns [N, B] (a mode's unread columns may be any tensor of
    the right dtype).  Returns u32 [N, B] for ``SEQ_MAX``, bool [N, B]
    otherwise.  The caller (:func:`dispersy_tpu_torch.kernels.store_probe`)
    has checked the inputs."""
    n, b = q_member.shape
    m = s_member.shape[1]
    mp, bp = _pow2(m), _pow2(b)
    rows = max(1, min(16, 8192 // (bp * mp)))
    rows = 1 << (rows.bit_length() - 1)
    if mode == SEQ_MAX:
        out = torch.empty((n, b), dtype=torch.uint32, device=q_member.device)
        out_bits = out.view(torch.int32)
    else:
        out = torch.empty((n, b), dtype=torch.bool, device=q_member.device)
        out_bits = out.view(torch.int8)
    grid = ((n + rows - 1) // rows,)
    _probe_kernel()[grid](
        s_gt.view(torch.int32), s_member.view(torch.int32), s_meta,
        s_payload.view(torch.int32), s_aux.view(torch.int32),
        q_member.view(torch.int32), q_gt.view(torch.int32), q_meta,
        q_payload.view(torch.int32), q_aux.view(torch.int32), out_bits, n,
        M=m, B=b, MP=mp, BP=bp, ROWS=rows, MODE=mode, num_warps=4)
    return out

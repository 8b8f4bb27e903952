"""Build, bind and launch the hand-written Hopper kernels.

The CUDA sources live in ``dispersy_tpu_torch/csrc``.  Each is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/kernels/`` (git-ignored) at first use -- one ``nvcc`` per
source, all started together -- and loaded with ``ctypes``.

Every wrapper here takes CUDA tensors only: it checks device, dtype,
shape and contiguity and raises :class:`KernelError` on anything its
kernel does not take, allocates outputs with ``torch.empty``, launches on
the current stream, raises if the launch reports an error, and adds one
to its entry of :data:`LAUNCHES`.  The CPU side of each op is the plain
version beside its wrapper in :mod:`dispersy_tpu_torch.ops`.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from dispersy_tpu_torch.exceptions import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("deliver", "bloom", "store", "compact", "stage", "timeline",
           "remove", "ragged", "match", "probe", "intake")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# One launch count per kernel, bumped where its wrapper launches it and
# nowhere else.
LAUNCHES = {"deliver": 0, "deliver_cls": 0, "deliver_ragged": 0,
            "bloom_build": 0, "bloom_query": 0,
            "digest_update": 0, "store_insert": 0, "store_insert_history": 0,
            "rank_compact_many": 0, "store_stage": 0, "intake_checks": 0,
            "dup_earlier": 0, "timeline_check": 0, "timeline_check_many": 0,
            "timeline_check_grant": 0, "timeline_check_grant_rev": 0,
            "store_match_flip": 0, "store_match_undo_marked": 0,
            "store_match_meta_of": 0, "store_match_undo_hits": 0,
            "store_remove": 0, "store_probe_conflict": 0,
            "store_probe_identity": 0, "store_probe_seq_max": 0}
_LIBS: dict = {}
MAX_COLS = 8           # csrc/deliver.cuh MAX_COLS, compact.cuh CMP_MAX_COLS
DELIVER_MAX_EDGES = 1 << 30  # csrc/deliver.cuh MAX_EDGES (look-back counts)
STORE_MAX_WIDTH = 256      # csrc/store.cu WMAX (M + B)
BLOOM_MAX_WORDS = 256      # csrc/bloom.cu MAX_WORDS
STAGE_MAX_SLOTS = 32       # csrc/stage.cu MAX_S
STORE_MAX_HISTORY = 24     # csrc/store.cu MAX_META
TIMELINE_MAX_SLOTS = 32    # csrc/timeline.cu MAX_A
TIMELINE_MAX_PAIRS = 3     # csrc/timeline.cu MAX_PAIRS
MATCH_MAX_WIDTH = 256      # csrc/match.cu MAX_W (16 B a slot, up to
                           # 32 rows a block in shared memory)
PROBE_MAX_WIDTH = 256      # csrc/probe.cu MAX_W (24 B a slot, up to 32
                           # rows a block in shared memory)
COMPACT_MAX_WIDTH = 8192   # csrc/compact.cuh CMP_MAX_INV (the inverse
                           # slot map of a block's rows in shared memory;
                           # K4's width, K10's M)
COMPACT_MAX_W = 32767      # csrc/compact.cuh CMP_MAX_W (entry index in
                           # int16)
INTAKE_MAX_WIDTH = 256     # csrc/intake.cu MAX_M (8 B a slot in shared
                           # memory)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found (the CUDA toolkit is needed to "
                          "build the kernels)")
    return path


def build(ptxas_report: bool = False) -> dict:
    """Compile every CUDA source whose library is missing or older than
    its sources, one ``nvcc`` each, all in parallel.  Returns
    ``{source: seconds}``, and with ``ptxas_report`` also
    ``{source + ".ptxas": text}`` (registers, shared memory, spills)."""
    out_dir = BUILD / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    headers = max(h.stat().st_mtime for h in CSRC.glob("*.cuh"))
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        src, lib = CSRC / f"{name}.cu", out_dir / f"lib{name}.so"
        newest = max(src.stat().st_mtime, headers)
        if (lib.exists() and lib.stat().st_mtime >= newest
                and not ptxas_report):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
               str(src)]
        if ptxas_report:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    failed = []
    for name, proc in procs.items():
        text, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{text}")
        elif ptxas_report:
            out[name + ".ptxas"] = text
    if failed:
        raise KernelError("\n".join(failed))
    return out


def _lib(name: str):
    if name not in _LIBS:
        path = BUILD / "kernels" / f"lib{name}.so"
        if not path.exists():
            build()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def _fn(lib: str, fn: str, n_args: int):
    """A C entry point whose arguments are all 64-bit (pointers, counts
    and the stream), returning a cudaError_t."""
    f = getattr(_lib(lib), fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * n_args
    return f


def _check(err: int, lib: str, what: str) -> None:
    if err != 0:
        msg = getattr(_lib(lib), "dk_error_string")
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_longlong]
        raise KernelError(f"{what}: CUDA error {err}: "
                          f"{msg(err).decode(errors='replace')}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _req(t: torch.Tensor, name: str, dtypes, shape=None,
         contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise KernelError(f"{name}: expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise KernelError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: shape {tuple(t.shape)} != "
                          f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise KernelError(f"{name}: must be contiguous")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * MAX_COLS)(*[t.data_ptr() for t in tensors])


def _i64s(values) -> ctypes.Array:
    return (ctypes.c_longlong * MAX_COLS)(*values)


_COL_DTYPES = (torch.uint32, torch.uint16, torch.uint8, torch.bool)


# ---- K1: deliver, K12: deliver_ragged -------------------------------------

def _edges(what, dst, cols, valid, cls, n_peers, inbox_size):
    """Check a delivery's edge list; returns (E, cls pointer, per-column
    row bytes)."""
    e = dst.shape[0]
    _req(dst, f"{what}.dst", (torch.int32,), (e,))
    _req(valid, f"{what}.valid", (torch.bool,), (e,))
    if cls is not None:
        _req(cls, f"{what}.cls", (torch.uint8,), (e,))
    if not 1 <= len(cols) <= MAX_COLS:
        raise KernelError(f"{what}: 1..{MAX_COLS} columns, got {len(cols)}")
    for i, c in enumerate(cols):
        _req(c, f"{what}.cols[{i}]", _COL_DTYPES)
        if c.shape[0] != e:
            raise KernelError(f"{what}.cols[{i}]: {c.shape[0]} rows != {e}")
    if inbox_size < 1:
        raise KernelError(f"{what}: inbox_size {inbox_size} < 1")
    if e >= DELIVER_MAX_EDGES or n_peers * inbox_size >= 2 ** 31 \
            or n_peers < 1:
        raise KernelError(f"{what}: {e} edges (at most "
                          f"{DELIVER_MAX_EDGES - 1}) or inbox index past "
                          "int32")
    row_bytes = [c.element_size() * math.prod(c.shape[1:]) for c in cols]
    return e, (None if cls is None else cls.data_ptr()), row_bytes


def _inboxes(cols, n_peers, q, e, dev):
    inbox = [torch.empty((n_peers, q) + tuple(c.shape[1:]), dtype=c.dtype,
                         device=dev) for c in cols]
    return (inbox, torch.empty((n_peers, q), dtype=torch.bool, device=dev),
            torch.empty(n_peers, dtype=torch.int32, device=dev),
            torch.empty(e, dtype=torch.int32, device=dev))


def _scratch(lib: str, fn: str, dev, *sizes) -> torch.Tensor:
    """The scratch a delivery call needs, as sized by its library (every
    argument a 64-bit integer, the row-bytes array by its address)."""
    f = getattr(_lib(lib), fn)
    f.restype = ctypes.c_longlong
    f.argtypes = [ctypes.c_longlong] * len(sizes)
    return torch.empty(f(*sizes), dtype=torch.uint8, device=dev)


def deliver(dst, cols, valid, n_peers: int, inbox_size: int, cls=None):
    """Stable radix-sort delivery (csrc/deliver.cu); with ``cls`` (u8
    admission classes) the order inside a destination is (class, edge).
    Returns ``(inbox, inbox_valid, n_dropped, edge_slot)``."""
    e, cls_ptr, row_bytes = _edges("deliver", dst, cols, valid, cls, n_peers,
                                   inbox_size)
    dev, q = dst.device, inbox_size
    inbox, inbox_valid, n_dropped, edge_slot = _inboxes(cols, n_peers, q, e,
                                                        dev)
    src, out, nbytes = _ptrs(cols), _ptrs(inbox), _i64s(row_bytes)
    scratch = _scratch("deliver", "dk_deliver_scratch", dev, e, n_peers,
                       int(cls is not None), len(cols),
                       ctypes.addressof(nbytes))
    err = _fn("deliver", "dk_deliver", 16)(
        dst.data_ptr(), valid.data_ptr(), cls_ptr, e, n_peers, q, len(cols),
        ctypes.addressof(src), ctypes.addressof(out),
        ctypes.addressof(nbytes), inbox_valid.data_ptr(),
        n_dropped.data_ptr(), edge_slot.data_ptr(), scratch.data_ptr(),
        scratch.numel(), _stream())
    _check(err, "deliver", "deliver")
    LAUNCHES["deliver" if cls is None else "deliver_cls"] += 1
    return inbox, inbox_valid, n_dropped, edge_slot


def deliver_ragged(dst, cols, valid, n_peers: int, inbox_size: int,
                   shards: int, budget: int = 0, cls=None,
                   need_receipts: bool = True):
    """The shard-local exchange with capped send buckets
    (csrc/ragged.cu).  Returns ``(inbox, inbox_valid, n_dropped,
    edge_slot, shed)``."""
    e, cls_ptr, row_bytes = _edges("deliver_ragged", dst, cols, valid, cls,
                                   n_peers, inbox_size)
    if shards < 2 or n_peers % shards or budget < 0:
        raise KernelError(f"deliver_ragged: shards {shards} must be >= 2 "
                          f"and divide n_peers {n_peers}; budget {budget} "
                          ">= 0")
    if shards * n_peers >= 2 ** 31:
        raise KernelError("deliver_ragged: shard histogram past int32")
    dev, q = dst.device, inbox_size
    inbox, inbox_valid, n_dropped, edge_slot = _inboxes(cols, n_peers, q, e,
                                                        dev)
    shed = torch.empty(e, dtype=torch.bool, device=dev)
    keep = torch.empty(e, dtype=torch.bool, device=dev)
    src, out, nbytes = _ptrs(cols), _ptrs(inbox), _i64s(row_bytes)
    scratch = _scratch("ragged", "dk_deliver_ragged_scratch", dev, e,
                       n_peers, shards, budget, int(cls is not None),
                       len(cols), ctypes.addressof(nbytes))
    err = _fn("ragged", "dk_deliver_ragged", 21)(
        dst.data_ptr(), valid.data_ptr(), cls_ptr, e, n_peers, q, shards,
        budget, int(need_receipts), len(cols), ctypes.addressof(src),
        ctypes.addressof(out), ctypes.addressof(nbytes),
        inbox_valid.data_ptr(), n_dropped.data_ptr(), edge_slot.data_ptr(),
        shed.data_ptr(), keep.data_ptr(), scratch.data_ptr(), scratch.numel(),
        _stream())
    _check(err, "ragged", "deliver_ragged")
    LAUNCHES["deliver_ragged"] += 1
    return inbox, inbox_valid, n_dropped, edge_slot, shed


# ---- K2: bloom build / query ---------------------------------------------

def _salt(salt, n: int) -> tuple:
    """(pointer, row stride) of a salt: None is unsalted, a 0-dim u32 one
    salt for every row (stride 0), a u32 [n] vector one salt per row."""
    if salt is None:
        return None, 0
    if salt.dim() == 0:
        _req(salt, "bloom.salt", (torch.uint32,), ())
        return salt.data_ptr(), 0
    _req(salt, "bloom.salt", (torch.uint32,), (n,))
    return salt.data_ptr(), 1


def _bloom_bits(n_bits: int) -> None:
    if n_bits <= 0 or n_bits % 32 or n_bits // 32 > BLOOM_MAX_WORDS:
        raise KernelError(f"bloom: n_bits {n_bits} must be a positive "
                          f"multiple of 32, at most {32 * BLOOM_MAX_WORDS}")


def bloom_reciprocal(n_bits: int) -> tuple:
    """``(magic, shift)`` with which csrc/bloom.cu takes ``x % n_bits``
    for every u32 ``x`` without a division: ``t = (x * magic) >> 32``,
    ``q = (t + ((x - t) >> 1)) >> shift``, ``x - q * n_bits`` (Granlund
    and Montgomery, "Division by invariant integers using multiplication",
    1994, fig. 4.1: the round-up reciprocal of ``2 <= n_bits < 2**32``
    with its 33rd bit carried by the ``(x - t) >> 1`` step)."""
    if not 2 <= n_bits < 1 << 32:
        raise KernelError(f"bloom_reciprocal: n_bits {n_bits} not in "
                          "[2, 2**32)")
    lg = (n_bits - 1).bit_length()          # ceil(log2(n_bits))
    return ((1 << 32) * ((1 << lg) - n_bits)) // n_bits + 1, lg - 1


def bloom_build(item_hashes, mask, n_bits: int, n_hashes: int, salt=None):
    """Shared-memory bitsets, a group of lanes per row (csrc/bloom.cu)."""
    n, m = item_hashes.shape
    _req(item_hashes, "bloom_build.item_hashes", (torch.uint32,))
    _req(mask, "bloom_build.mask", (torch.bool,), (n, m))
    _bloom_bits(n_bits)
    words = torch.empty((n, n_bits // 32), dtype=torch.uint32,
                        device=mask.device)
    err = _fn("bloom", "dk_bloom_build", 12)(
        item_hashes.data_ptr(), mask.data_ptr(), n, m, n_bits, n_hashes,
        *_salt(salt, n), *bloom_reciprocal(n_bits), words.data_ptr(),
        _stream())
    _check(err, "bloom", "bloom_build")
    LAUNCHES["bloom_build"] += 1
    return words


def digest_update(digest, item_hashes, mask, n_bits: int, n_hashes: int,
                  salt=None):
    """K6: a new digest, ``digest`` with the masked items' probe bits ORed
    in; K2's build kernel started from the digest (csrc/bloom.cu)."""
    n, m = item_hashes.shape
    _req(item_hashes, "digest_update.item_hashes", (torch.uint32,))
    _req(mask, "digest_update.mask", (torch.bool,), (n, m))
    _bloom_bits(n_bits)
    _req(digest, "digest_update.digest", (torch.uint32,), (n, n_bits // 32))
    words = torch.empty_like(digest)
    err = _fn("bloom", "dk_digest_update", 13)(
        digest.data_ptr(), item_hashes.data_ptr(), mask.data_ptr(), n, m,
        n_bits, n_hashes, *_salt(salt, n), *bloom_reciprocal(n_bits),
        words.data_ptr(), _stream())
    _check(err, "bloom", "digest_update")
    LAUNCHES["digest_update"] += 1
    return words


def bloom_query(words, item_hashes, n_bits: int, n_hashes: int, salt=None):
    """All-k-bits membership test per item (csrc/bloom.cu); ``words`` may
    be a row-strided [N, W] view."""
    n, m = item_hashes.shape
    _req(item_hashes, "bloom_query.item_hashes", (torch.uint32,))
    _req(words, "bloom_query.words", (torch.uint32,), (n, n_bits // 32),
         contiguous=False)
    _bloom_bits(n_bits)
    if words.stride(1) != 1:
        raise KernelError("bloom_query.words: each row must be contiguous")
    out = torch.empty((n, m), dtype=torch.bool, device=words.device)
    err = _fn("bloom", "dk_bloom_query", 13)(
        words.data_ptr(), words.stride(0), item_hashes.data_ptr(), n, m,
        n_bits, n_hashes, *_salt(salt, n), *bloom_reciprocal(n_bits),
        out.data_ptr(), _stream())
    _check(err, "bloom", "bloom_query")
    LAUNCHES["bloom_query"] += 1
    return out


# ---- K3: store insert ------------------------------------------------------

_AUX_DT = (torch.uint32, torch.uint16)


def _store_dts(aux_dtype) -> tuple:
    """The six record-column dtypes, with the given aux dtype."""
    return (torch.uint32, torch.uint32, torch.uint8, torch.uint32,
            aux_dtype, torch.uint8)


def _req_cols(cols, name: str, shape, aux_dtypes=_AUX_DT) -> None:
    _req(cols[4], f"{name}[4]", aux_dtypes, shape)
    for i, (c, dt) in enumerate(zip(cols, _store_dts(cols[4].dtype))):
        _req(c, f"{name}[{i}]", (dt,), shape)


def store_insert(store, new, new_mask, history: tuple = ()):
    """Per-row merge, dup kill, LastSync keep-last-k (``history``, per
    user meta; empty or all zero for none) and fused compaction
    (csrc/store.cu).  Returns the six [N, M] columns and the three i32[N]
    counts.  The aux column is u32 or u16, the same in ``store`` and
    ``new``."""
    n, m = store[0].shape
    b = new[0].shape[1]
    _req_cols(store, "store_insert.store", (n, m))
    _req_cols(new, "store_insert.new", (n, b), (store[4].dtype,))
    _req(new_mask, "store_insert.new_mask", (torch.bool,), (n, b))
    if m < 1 or m + b > STORE_MAX_WIDTH:
        raise KernelError(f"store_insert: M + B = {m + b} not in "
                          f"[1, {STORE_MAX_WIDTH}]")
    history = tuple(history) if any(k > 0 for k in history) else ()
    if len(history) > STORE_MAX_HISTORY:
        raise KernelError(f"store_insert: {len(history)} history metas > "
                          f"{STORE_MAX_HISTORY}")
    dev = new_mask.device
    hist = (ctypes.c_int32 * max(len(history), 1))(*history)
    out = [torch.empty((n, m), dtype=dt, device=dev)
           for dt in _store_dts(store[4].dtype)]
    counts = torch.empty((3, n), dtype=torch.int32, device=dev)
    err = _fn("store", "dk_store_insert", 27)(
        *[c.data_ptr() for c in store], *[c.data_ptr() for c in new],
        new_mask.data_ptr(), n, m, b, store[4].element_size(),
        ctypes.addressof(hist), len(history),
        *[c.data_ptr() for c in out], counts.data_ptr(), _stream())
    _check(err, "store", "store_insert")
    LAUNCHES["store_insert_history" if history else "store_insert"] += 1
    return (*out, counts[0], counts[1], counts[2])


# ---- K10: store remove -----------------------------------------------------

def store_remove(store, kill):
    """Delete the masked records, survivors compacted left: each block's
    slot map computed from gt and kill, inverted in shared memory and
    gathered as K4 gathers (csrc/remove.cu).  Returns the six [N, M]
    columns and the i32[N] removed count."""
    n, m = store[0].shape
    _req_cols(store, "store_remove.store", (n, m))
    _req(kill, "store_remove.kill", (torch.bool,), (n, m))
    if not 1 <= m <= COMPACT_MAX_WIDTH:
        raise KernelError(f"store_remove: M = {m} not in "
                          f"[1, {COMPACT_MAX_WIDTH}]")
    dev = kill.device
    out = [torch.empty((n, m), dtype=dt, device=dev)
           for dt in _store_dts(store[4].dtype)]
    n_removed = torch.empty(n, dtype=torch.int32, device=dev)
    err = _fn("remove", "dk_store_remove", 18)(
        *[c.data_ptr() for c in store], kill.data_ptr(), n, m,
        store[4].element_size(), *[c.data_ptr() for c in out],
        n_removed.data_ptr(), _stream())
    _check(err, "remove", "store_remove")
    LAUNCHES["store_remove"] += 1
    return (*out, n_removed)


# ---- K8: timeline check ----------------------------------------------------

def _u32_2d(t, name: str, shape) -> torch.Tensor:
    """A [N, Q] u32 query operand, broadcast and made contiguous."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise KernelError(f"{name}: expected a CUDA tensor")
    if t.dtype != torch.uint32:
        raise KernelError(f"{name}: dtype {t.dtype} is not torch.uint32")
    return t.view(torch.int32).expand(shape).contiguous().view(torch.uint32)


def _timeline_args(tab, member, gt, keys, name: str):
    """Check a K8 call's table and queries; returns (N, Q, A, member, gt,
    keys), the queries broadcast to [N, Q] and made contiguous (u8 keys
    stay u8)."""
    n, a = tab.member.shape
    for i, (c, dt) in enumerate(zip(tab[:4], (torch.uint32, torch.uint32,
                                               torch.uint32, torch.bool))):
        _req(c, f"{name}.tab[{i}]", (dt,), (n, a))
    if not 1 <= a <= TIMELINE_MAX_SLOTS:
        raise KernelError(f"{name}: A = {a} not in "
                          f"[1, {TIMELINE_MAX_SLOTS}]")
    shape = torch.broadcast_shapes(member.shape, gt.shape,
                                   *(k.shape for k in keys))
    if len(shape) != 2 or shape[0] != n or shape[1] < 1:
        raise KernelError(f"{name}: queries of shape {tuple(shape)} for "
                          f"{n} rows")
    out = []
    for i, k in enumerate(keys):
        if k.dtype in (torch.uint8, torch.bool):
            _req(k, f"{name}.key[{i}]", (k.dtype,), contiguous=False)
            out.append(k.expand(shape).contiguous())
        else:
            out.append(_u32_2d(k, f"{name}.key[{i}]", shape))
    return (n, shape[1], a, _u32_2d(member, f"{name}.member", shape),
            _u32_2d(gt, f"{name}.gt", shape), out)


def _founder_arg(founder, n: int, name: str):
    """(column or None, stride, value) of a founder int or u32 column."""
    if not isinstance(founder, torch.Tensor):
        return None, 0, int(founder) & 0xFFFFFFFF
    _req(founder, f"{name}.founder", (torch.uint32,), contiguous=False)
    col = founder.reshape(-1).contiguous()
    if col.shape[0] == 1:
        return col, 0, 0
    if col.shape[0] != n:
        raise KernelError(f"{name}: founder column of {col.shape[0]} rows "
                          f"for {n}")
    return col, 1, 0


def _timeline_check(tab, member, keys_perms, gt, founder, name: str):
    """One K8 ``check`` launch over up to three (meta, perm) pairs."""
    if not 1 <= len(keys_perms) <= TIMELINE_MAX_PAIRS:
        raise KernelError(f"{name}: 1..{TIMELINE_MAX_PAIRS} (meta, perm) "
                          f"pairs, got {len(keys_perms)}")
    n, q, a, member, gt, keys = _timeline_args(
        tab, member, gt, [k for k, _ in keys_perms], name)
    col, stride, val = _founder_arg(founder, n, name)
    outs = torch.empty((len(keys), n, q), dtype=torch.bool,
                       device=member.device)
    k_ptrs, o_ptrs = _ptrs(keys), _ptrs(outs)
    sizes = _i64s([k.element_size() for k in keys])
    perms = _i64s([int(p) for _, p in keys_perms])
    err = _fn("timeline", "dk_timeline_check", 18)(
        *[c.data_ptr() for c in tab[:4]], member.data_ptr(), gt.data_ptr(),
        n, q, a, len(keys), ctypes.addressof(k_ptrs), ctypes.addressof(sizes),
        ctypes.addressof(perms), None if col is None else col.data_ptr(),
        stride, val, ctypes.addressof(o_ptrs), _stream())
    _check(err, "timeline", name)
    return tuple(outs)


def timeline_check(tab, member, meta, gt, founder, perm: int):
    """K8 ``check``: bool [N, Q] (csrc/timeline.cu).  ``meta`` is u8 or
    u32; ``founder`` an int or a u32 column of one value per row."""
    out, = _timeline_check(tab, member, [(meta, perm)], gt, founder,
                           "timeline_check")
    LAUNCHES["timeline_check"] += 1
    return out


def timeline_check_many(tab, member, keys_perms, gt, founder):
    """K8 ``check`` of one (member, gt, founder) query for each of up to
    three (meta, perm) pairs, one walk of the table: a tuple of bool
    [N, Q] (csrc/timeline.cu)."""
    out = _timeline_check(tab, member, keys_perms, gt, founder,
                          "timeline_check_many")
    LAUNCHES["timeline_check_many"] += 1
    return out


def _timeline_grant(tab, member, mask, gt, n_meta: int, perm: int, is_rev,
                    name: str):
    """One K8 ``check_grant`` launch: ``perm`` for every query, or with
    the bool ``is_rev`` the kernel's REVOKE where it is set and AUTHORIZE
    elsewhere (``perm`` unused)."""
    keys = [mask] if is_rev is None else [mask, is_rev]
    n, q, a, member, gt, keys = _timeline_args(tab, member, gt, keys, name)
    if keys[0].dtype != torch.uint32:
        raise KernelError(f"{name}: mask dtype {keys[0].dtype} is not "
                          "torch.uint32")
    rev_ptr = None
    if is_rev is not None:
        if is_rev.dtype != torch.bool:
            raise KernelError(f"{name}: is_rev dtype {is_rev.dtype} is not "
                              "torch.bool")
        rev_ptr = keys[1].data_ptr()
    out = torch.empty((n, q), dtype=torch.bool, device=member.device)
    err = _fn("timeline", "dk_timeline_check_grant", 15)(
        *[c.data_ptr() for c in tab[:4]], member.data_ptr(),
        keys[0].data_ptr(), gt.data_ptr(), n, q, a, n_meta, perm, rev_ptr,
        out.data_ptr(), _stream())
    _check(err, "timeline", name)
    return out


def timeline_check_grant(tab, member, mask, gt, n_meta: int, perm: int):
    """K8 ``check_grant``: bool [N, Q] (csrc/timeline.cu)."""
    out = _timeline_grant(tab, member, mask, gt, n_meta, perm, None,
                          "timeline_check_grant")
    LAUNCHES["timeline_check_grant"] += 1
    return out


def timeline_check_grant_rev(tab, member, mask, gt, is_rev, n_meta: int):
    """K8 ``check_grant`` with the perm per query: REVOKE where the bool
    ``is_rev`` is set, AUTHORIZE elsewhere (csrc/timeline.cu)."""
    out = _timeline_grant(tab, member, mask, gt, n_meta, 0, is_rev,
                          "timeline_check_grant_rev")
    LAUNCHES["timeline_check_grant_rev"] += 1
    return out


# ---- K4: rank compaction ---------------------------------------------------

def rank_compact_many(cols_fills, slot, width: int):
    """Inverse-slot gather of several columns (csrc/compact.cu): every
    output element is written once, by the kernel."""
    n, w = slot.shape
    _req(slot, "rank_compact_many.slot", (torch.int32,), (n, w))
    if not 1 <= len(cols_fills) <= MAX_COLS:
        raise KernelError(f"rank_compact_many: 1..{MAX_COLS} columns")
    if not (1 <= width <= COMPACT_MAX_WIDTH and 1 <= w <= COMPACT_MAX_W):
        raise KernelError(f"rank_compact_many: width {width} not in [1, "
                          f"{COMPACT_MAX_WIDTH}] or W {w} not in [1, "
                          f"{COMPACT_MAX_W}]")
    srcs, outs, fills = [], [], []
    for i, (c, fill) in enumerate(cols_fills):
        _req(c, f"rank_compact_many.cols[{i}]", _COL_DTYPES, (n, w))
        srcs.append(c)
        outs.append(torch.empty((n, width), dtype=c.dtype, device=c.device))
        bits = 8 * c.element_size()
        fills.append(int(fill) & ((1 << bits) - 1))
    # The host arrays stay referenced until the call returns.
    src, dst = _ptrs(srcs), _ptrs(outs)
    size, fill = _i64s([c.element_size() for c in srcs]), _i64s(fills)
    err = _fn("compact", "dk_rank_compact", 10)(
        slot.data_ptr(), n, w, width, len(srcs), ctypes.addressof(src),
        ctypes.addressof(dst), ctypes.addressof(size),
        ctypes.addressof(fill), _stream())
    _check(err, "compact", "rank_compact_many")
    LAUNCHES["rank_compact_many"] += 1
    return outs


# ---- K7: store stage -------------------------------------------------------

def store_stage(staging, new, new_mask):
    """Append the masked batch after each row's valid entries, a group of
    lanes per row, every output slot written once (csrc/stage.cu).
    Returns the six [N, S] staging columns, the landed mask and the
    i32[N] overflow count.  ``new``'s aux (u32 or u16) is cast to the
    staging's aux width in the kernel."""
    n, s = staging[0].shape
    b = new[0].shape[1]
    _req_cols(staging, "store_stage.staging", (n, s))
    _req_cols(new, "store_stage.new", (n, b))
    _req(new_mask, "store_stage.new_mask", (torch.bool,), (n, b))
    if not 1 <= s <= STAGE_MAX_SLOTS:
        raise KernelError(f"store_stage: S = {s} not in "
                          f"[1, {STAGE_MAX_SLOTS}]")
    dev = new_mask.device
    out = [torch.empty((n, s), dtype=dt, device=dev)
           for dt in _store_dts(staging[4].dtype)]
    landed = torch.empty((n, b), dtype=torch.bool, device=dev)
    n_dropped = torch.empty(n, dtype=torch.int32, device=dev)
    # The host arrays stay referenced until the call returns.
    s_ptrs, b_ptrs, o_ptrs = _ptrs(staging), _ptrs(new), _ptrs(out)
    err = _fn("stage", "dk_store_stage", 12)(
        ctypes.addressof(s_ptrs), ctypes.addressof(b_ptrs),
        new_mask.data_ptr(), n, s, b, staging[4].element_size(),
        new[4].element_size(), ctypes.addressof(o_ptrs), landed.data_ptr(),
        n_dropped.data_ptr(), _stream())
    _check(err, "stage", "store_stage")
    LAUNCHES["store_stage"] += 1
    return (*out, landed, n_dropped)


# ---- K5: intake checks ------------------------------------------------------

def _intake(what: str, store_gt, store_member, member, gt, ok):
    """Launch csrc/intake.cu; with ``store_gt`` None, ``dup_earlier``
    alone (no ring read, no ``in_store`` answer)."""
    n, b = gt.shape
    _req(member, f"{what}.member", (torch.uint32,), (n, b))
    _req(gt, f"{what}.gt", (torch.uint32,), (n, b))
    _req(ok, f"{what}.ok", (torch.bool,), (n, b))
    m = 0
    if store_gt is not None:
        m = store_gt.shape[1]
        _req(store_gt, f"{what}.store_gt", (torch.uint32,), (n, m))
        _req(store_member, f"{what}.store_member", (torch.uint32,), (n, m))
        if not 1 <= m <= INTAKE_MAX_WIDTH:
            raise KernelError(f"{what}: M = {m} not in [1, "
                              f"{INTAKE_MAX_WIDTH}]")
    if b < 1:
        raise KernelError(f"{what}: B must be >= 1")
    dup = torch.empty((n, b), dtype=torch.bool, device=gt.device)
    ins = (None if store_gt is None else
           torch.empty((n, b), dtype=torch.bool, device=gt.device))
    err = _fn("intake", "dk_intake", 11)(
        *[None if t is None else t.data_ptr() for t in (
            store_gt, store_member, member, gt, ok, ins, dup)], n, m, b,
        _stream())
    _check(err, "intake", what)
    return dup if ins is None else (ins, dup)


def intake_checks(store_gt, store_member, member, gt, ok):
    """(in_store, dup_earlier), each bool [N, B]: a binary search of each
    entry in its row's sorted ring (every slot compared in a row out of
    order) and a warp match over the batch (csrc/intake.cu)."""
    out = _intake("intake_checks", store_gt, store_member, member, gt, ok)
    LAUNCHES["intake_checks"] += 1
    return out


def dup_earlier(member, gt, ok):
    """K5 without a store operand: ``dup_earlier`` alone, bool [N, B]."""
    out = _intake("dup_earlier", None, None, member, gt, ok)
    LAUNCHES["dup_earlier"] += 1
    return out


# ---- K9: store match --------------------------------------------------------

MATCH_MODES = {"flip": 0, "undo_marked": 1, "meta_of": 2, "undo_hits": 3}


def store_match(mode: str, w_cols, q_cols):
    """K9 in ``mode`` (:data:`MATCH_MODES`; csrc/match.cu): ``w_cols`` is
    the row's entries -- a flag (bool) or meta (u8) column, then two u32
    key columns and, for ``"flip"``, the u32 aux -- and ``q_cols`` the two
    query columns, u32 (the first may be a u8 meta, read as bytes).
    Returns u32 [N, Q] for ``"flip"`` and ``"meta_of"``, bool [N, Q]
    otherwise."""
    flag, w1, w2, *wv = w_cols
    n, w = w1.shape
    if mode not in MATCH_MODES:
        raise KernelError(f"store_match: unknown mode {mode!r}")
    flag_dt = torch.bool if mode in ("flip", "undo_hits") else torch.uint8
    _req(flag, f"store_match.{mode}.flag", (flag_dt,), (n, w))
    for i, c in enumerate([w1, w2, *wv]):
        _req(c, f"store_match.{mode}.w[{i}]", (torch.uint32,), (n, w))
    if (mode == "flip") != bool(wv):
        raise KernelError("store_match: the aux column goes with 'flip' "
                          "only")
    shape = torch.broadcast_shapes(*(c.shape for c in q_cols))
    if (len(shape) != 2 or shape[0] != n or shape[1] < 1
            or not 1 <= w <= MATCH_MAX_WIDTH):
        raise KernelError(f"store_match: queries {tuple(shape)} against "
                          f"[{n}, {w}] (W at most {MATCH_MAX_WIDTH})")
    q1, q2 = q_cols
    q1_u8 = q1.dtype == torch.uint8   # a meta column, read as bytes
    if q1_u8:
        _req(q1, f"store_match.{mode}.q[0]", (torch.uint8,), contiguous=False)
        q1 = q1.expand(shape).contiguous()
    else:
        q1 = _u32_2d(q1, f"store_match.{mode}.q[0]", shape)
    q2 = _u32_2d(q2, f"store_match.{mode}.q[1]", shape)
    dt = torch.uint32 if mode in ("flip", "meta_of") else torch.bool
    out = torch.empty(shape, dtype=dt, device=q2.device)
    err = _fn("match", "dk_store_match", 13)(
        MATCH_MODES[mode], flag.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        (wv[0] if wv else w1).data_ptr(), q1.data_ptr(), int(q1_u8),
        q2.data_ptr(), out.data_ptr(), n, w, shape[1], _stream())
    _check(err, "match", f"store_match {mode}")
    LAUNCHES[f"store_match_{mode}"] += 1
    return out


# ---- K11: store probe ---------------------------------------------------------

PROBE_MODES = {"conflict": 0, "identity": 1, "seq_max": 2}
# The store columns each K11 mode reads, by StoreCols name, and its batch
# columns, each with its dtype.
_PROBE_STORE = {"conflict": ("gt", "member", "meta", "payload", "aux"),
                "identity": ("meta", "member"),
                "seq_max": ("gt", "member", "meta", "aux")}
_PROBE_QUERY = {"conflict": ("member", "gt", "meta", "payload", "aux"),
                "identity": ("member",),
                "seq_max": ("member", "meta")}
_PROBE_ORDER = ("gt", "member", "meta", "payload", "aux")


def store_probe(mode: str, s_cols, q_cols):
    """K11 in ``mode`` (:data:`PROBE_MODES`; csrc/probe.cu): ``s_cols``
    the mode's store columns [N, M] and ``q_cols`` its batch columns [N,
    B], in the order of :data:`_PROBE_STORE` / :data:`_PROBE_QUERY`
    (metas u8, read as bytes; every other column u32).  Returns bool [N,
    B], or u32 [N, B] for ``"seq_max"``."""
    if mode not in PROBE_MODES:
        raise KernelError(f"store_probe: unknown mode {mode!r}")
    names_s, names_q = _PROBE_STORE[mode], _PROBE_QUERY[mode]
    if len(s_cols) != len(names_s) or len(q_cols) != len(names_q):
        raise KernelError(f"store_probe {mode}: columns {names_s} and "
                          f"{names_q}")
    s = dict(zip(names_s, s_cols))
    q = dict(zip(names_q, q_cols))
    n, m = s["member"].shape
    b = q["member"].shape[1] if q["member"].dim() == 2 else 0
    for side, cols, shape in (("store", s, (n, m)), ("q", q, (n, b))):
        for name, c in cols.items():
            dt = torch.uint8 if name == "meta" else torch.uint32
            _req(c, f"store_probe.{mode}.{side}_{name}", (dt,), shape)
    if not 1 <= m <= PROBE_MAX_WIDTH or b < 1:
        raise KernelError(f"store_probe {mode}: M = {m} not in [1, "
                          f"{PROBE_MAX_WIDTH}] or B = {b} < 1")
    dt = torch.uint32 if mode == "seq_max" else torch.bool
    out = torch.empty((n, b), dtype=dt, device=q["member"].device)

    def ptrs(cols):       # a mode's unread columns are null
        return [cols[k].data_ptr() if k in cols else None
                for k in _PROBE_ORDER]
    err = _fn("probe", "dk_store_probe", 16)(
        PROBE_MODES[mode], *ptrs(s), *ptrs(q), out.data_ptr(), n, m, b,
        _stream())
    _check(err, "probe", f"store_probe {mode}")
    LAUNCHES[f"store_probe_{mode}"] += 1
    return out


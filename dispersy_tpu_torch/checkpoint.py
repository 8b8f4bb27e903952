"""Single-file checkpoints of the overlay state (port of the single-run
archives of ``dispersy_tpu/checkpoint.py``).

An archive is one ``.npz``: every ``PeerState`` leaf under
``leaf:<name>`` in its schema dtype (a stats counter is
``leaf:stats/<field>``), a CRC32 of each leaf's C-contiguous bytes under
``crc:<name>``, the format version under ``meta:version`` and the config
fingerprint (``repr(cfg)``, equal in both packages) under
``meta:config``.  The keys, dtypes and checks are the JAX package's, so
an archive written by either package restores in the other.

Two restore modes: ``fresh_candidates=False`` resumes byte for byte (the
RNG key and round counter ride in the archive); ``fresh_candidates=True``
is an application restart on the same database -- the community-instance
memory dies (:func:`_wipe_ephemeral`) and ``loaded`` follows
``cfg.auto_load``.

Archives of formats 7-16 restore as the JAX package restores them: leaves
introduced later start at the config's empty values, a v7 archive's u32
meta and flags columns narrow to u8, a pre-v14 archive's full-width
plane leaves are checked empty and sized down, and the fingerprint is
compared with the planes the old format predates stripped (only their
defaults can match).  Fleet archives (``meta:replicas``) and the sharded
layout are not read here: :func:`restore` refuses a fleet archive.
"""

from __future__ import annotations

import functools
import glob
import io
import os
import zipfile
import zlib

import numpy as np
import torch

from dispersy_tpu_torch.bridge import leaf_names as _dotted_names
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.exceptions import CheckpointError
from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                       ParallelConfig, RecoveryConfig,
                                       StoreConfig, TelemetryConfig,
                                       TraceConfig)
from dispersy_tpu_torch.state import (PeerState, Stats, init_state,
                                      resolve_device, wipe_instance_memory)
from dispersy_tpu_torch.u32 import bits, unbits

# The format's history is the JAX package's (its module comment): v8
# narrowed the meta / flags columns to u8, v9 added the per-leaf CRCs,
# v10-v17 each added a plane's leaves (telemetry, fleet archives,
# recovery, overload, the byte-diet store, tracing, the parallel plane,
# the cohort cadence and the u16 candidate stamps).
FORMAT_VERSION = 17
_ACCEPTED_VERSIONS = (7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                      FORMAT_VERSION)

# Leaves whose dtype narrowed u32 -> u8 at v8 (truncation is lossless:
# the empty sentinel is EMPTY_U32's low byte).
_NARROWED_V8 = frozenset(
    {"store_meta", "store_flags", "fwd_meta", "dly_meta"})

# The leaves each format version introduced: an older archive lacks them
# and restore starts them at the config template's values.
_NEW_BY_VERSION: dict = {
    9: frozenset({"health", "ge_bad", "stats/msgs_corrupt_dropped"}),
    10: frozenset({"walk_streak", "tele_row", "tele_ring", "fr_ring",
                   "fr_pos"}),
    12: frozenset({"backoff", "quar_until", "repair_round",
                   "stats/recov_soft", "stats/recov_backoff",
                   "stats/recov_quarantine", "stats/recov_cleared"}),
    13: frozenset({"bucket", "stats/msgs_shed_rate",
                   "stats/msgs_shed_priority"}),
    14: frozenset({"sta_gt", "sta_member", "sta_meta", "sta_payload",
                   "sta_aux", "sta_flags", "digest"}),
    15: frozenset({"trace_member", "trace_gt", "trace_first", "trace_chan",
                   "trace_dups", "trace_latch", "stats/trace_delivered",
                   "stats/trace_dup"}),
    16: frozenset({"stats/xshard_shed"}),
    17: frozenset({"cohort", "epoch"}),
}

# Leaves v14 made plane-sized (zero-width when their feature is compiled
# out): a pre-v14 archive carries them at full width but empty.  Leaf ->
# its empty fill.
_PLANE_SIZED_FILLS = {
    "auth_member": 0xFFFFFFFF, "auth_mask": 0, "auth_gt": 0,
    "auth_rev": False, "auth_issuer": 0xFFFFFFFF,
    "mal_member": 0xFFFFFFFF,
    "sig_target": -1, "sig_meta": 0, "sig_payload": 0, "sig_gt": 0,
    "sig_since": 0,
    **{f"stats/{nm}": 0 for nm in (
        "msgs_rejected", "msgs_direct", "msgs_delayed",
        "proof_requests", "proof_records", "seq_requests", "seq_records",
        "mm_requests", "mm_records", "id_requests", "id_records",
        "sig_signed", "sig_done", "sig_expired", "conflicts",
        "convictions_rx", "auth_unwound", "msgs_retro")},
}

# What a corrupt archive raises mid-read (np.load parses only the zip
# directory; a flipped byte in a member surfaces from ``z[key]``).
_ARCHIVE_ERRORS = (zipfile.BadZipFile, zlib.error, EOFError, OSError,
                   ValueError)

# The unsigned words cross to and from the device through their signed
# views (numpy dtype -> the torch dtype and its signed view).
_NP_UNSIGNED = {np.dtype(np.uint32): (torch.uint32, np.int32),
                np.dtype(np.uint16): (torch.uint16, np.int16)}


def leaf_names() -> list:
    """Every leaf's archive name (``stats/<field>`` for a counter), in
    ``PeerState`` order."""
    return [n.replace(".", "/") for n in _dotted_names()]


def _missing_ok(name: str, version: int) -> bool:
    """May ``name`` be absent from a ``version`` archive?"""
    return any(version < v and name in new
               for v, new in _NEW_BY_VERSION.items())


def leaf_manifest(cfg: CommunityConfig | None = None) -> dict:
    """Every leaf's archive name -> the format version that introduced it
    (the oldest accepted version for the leaves older than the registry).
    The names do not depend on ``cfg``."""
    out = {}
    for name in leaf_names():
        new = [v for v, s in _NEW_BY_VERSION.items() if name in s]
        out[name] = max(new) if new else _ACCEPTED_VERSIONS[0]
    return out


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _verify_crc(z, key: str, arr: np.ndarray, what: str) -> None:
    crc_key = f"crc:{key[len('leaf:'):]}"
    if crc_key not in z:
        raise CheckpointError(f"checkpoint {what}: CRC entry {crc_key} "
                              "missing -- truncated or foreign archive")
    want, got = int(z[crc_key]), _crc(arr)
    if got != want:
        raise CheckpointError(
            f"checkpoint {what}: CRC mismatch on {key} (stored "
            f"{want:#010x}, computed {got:#010x}) -- corrupt archive, "
            "refusing to restore")


def _upconvert_v7(name: str, arr: np.ndarray, want) -> np.ndarray:
    if (name in _NARROWED_V8 and arr.dtype == np.uint32
            and np.dtype(want) == np.uint8):
        return arr.astype(np.uint8)
    return arr


def _resize_plane_leaf(name: str, arr: np.ndarray, t_shape: tuple,
                       t_dtype, what: str) -> np.ndarray:
    """A pre-v14 archive's full-width plane leaf sized down to the
    template's width, refusing when any content would be lost."""
    if name not in _PLANE_SIZED_FILLS:
        return arr
    if tuple(arr.shape) == t_shape or arr.dtype != t_dtype:
        return arr
    fill = _PLANE_SIZED_FILLS[name]
    if arr.dtype != np.bool_:
        fill = np.asarray(fill, arr.dtype)
    if arr.size and not np.all(arr == fill):
        raise CheckpointError(
            f"checkpoint {what}: field {name} carries data for a feature "
            "the given config compiles out (plane-sized leaf) -- restore "
            "under the config that produced it")
    return np.broadcast_to(np.asarray(fill, t_dtype), t_shape).copy()


def _fingerprint(cfg: CommunityConfig) -> str:
    """The config identity an archive is valid against."""
    return repr(cfg)


def _strip(full: str, comp: str, what: str) -> str:
    if full.count(comp) != 1:
        raise CheckpointError(f"cannot derive the pre-{what} fingerprint: "
                              f"{comp.strip(', ')} is not where it was")
    return full.replace(comp, "", 1)


def _want_fingerprint(cfg: CommunityConfig, version: int) -> str:
    """The fingerprint an archive of ``version`` should carry for ``cfg``:
    each plane a format predates is stripped from ``repr(cfg)``, and only
    that plane's default config can match the old writer."""
    if version >= 17:
        return _fingerprint(cfg)
    if cfg.store.cohorts != 1 or cfg.store.cand_bits != 32:
        raise CheckpointError(
            f"checkpoint format {version} predates the cohort-staggered "
            "store fields; it can only restore under the defaults "
            "(cfg.store.cohorts == 1 and cfg.store.cand_bits == 32)")
    sfields = ", cohorts=1, cand_bits=32"
    full = _strip(repr(cfg), sfields, "v17")
    steps = (
        (16, "parallel", ParallelConfig, cfg.parallel),
        (15, "trace", TraceConfig, cfg.trace),
        (14, "store", StoreConfig, cfg.store),
        (13, "overload", OverloadConfig, cfg.overload),
        (12, "recovery", RecoveryConfig, cfg.recovery),
        (10, "telemetry", TelemetryConfig, cfg.telemetry),
    )
    for since, field, default, value in steps:
        if version >= since:
            return full
        if value != default():
            raise CheckpointError(
                f"checkpoint format {version} predates the {field} plane; "
                f"it can only restore under the default "
                f"{default.__name__} (cfg.{field} must be "
                f"{default.__name__}())")
        comp = f", {field}={value!r}"
        if field == "store":
            comp = comp.replace(sfields, "", 1)
        full = _strip(full, comp, f"v{since}")
    if version >= 9:
        return full
    if cfg.faults != FaultModel():
        raise CheckpointError(
            f"checkpoint format {version} predates the fault model; it "
            "can only restore under the default FaultModel "
            "(cfg.faults must be FaultModel())")
    suffix = f", faults={cfg.faults!r})"
    if not full.endswith(suffix):
        raise CheckpointError("cannot derive the pre-v9 fingerprint: "
                              "faults is no longer the last config field")
    return full[:-len(suffix)] + ")"


def _np_load(path: str):
    """``np.load`` with an unreadable or truncated archive raised as
    :class:`CheckpointError`."""
    try:
        return np.load(path)
    except Exception as e:  # noqa: BLE001 -- BadZipFile, EOF, OSError, ...
        raise CheckpointError(
            f"checkpoint {path} unreadable ({type(e).__name__}: {e}) -- "
            "truncated or torn archive") from e


def _archive_guard(fn):
    """Corruption that surfaces mid-read raises :class:`CheckpointError`
    too (a resume scan skips such a snapshot)."""
    @functools.wraps(fn)
    def wrapped(path, cfg, *args, **kwargs):
        try:
            return fn(path, cfg, *args, **kwargs)
        except CheckpointError:
            raise
        except _ARCHIVE_ERRORS as e:
            raise CheckpointError(
                f"checkpoint {path}: read failed mid-restore "
                f"({type(e).__name__}: {e}) -- corrupt or torn "
                "archive") from e
    return wrapped


def _leaf(state, name: str) -> torch.Tensor:
    leaf = state
    for part in name.split("/"):
        leaf = getattr(leaf, part)
    return leaf


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf on the host in its schema dtype (u32 / u16 through the
    signed view)."""
    return bits(t).detach().cpu().numpy().view(_np_dtype(t))


def _to_torch(arr: np.ndarray, dev) -> torch.Tensor:
    arr = np.array(arr, order="C")      # keeps a 0-d leaf 0-d
    if arr.dtype in _NP_UNSIGNED:
        dtype, signed = _NP_UNSIGNED[arr.dtype]
        return unbits(torch.from_numpy(arr.view(signed)).to(dev), dtype)
    return torch.from_numpy(arr).to(dev)


def save(path: str, state: PeerState, cfg: CommunityConfig) -> None:
    """Write the whole state to ``path`` (.npz) with one CRC32 a leaf,
    atomically (a temporary file, then a rename)."""
    names = leaf_names()
    arrays = {f"leaf:{n}": _to_numpy(_leaf(state, n)) for n in names}
    for n in names:
        arrays[f"crc:{n}"] = np.asarray(_crc(arrays[f"leaf:{n}"]),
                                        np.uint32)
    arrays["meta:version"] = np.asarray(FORMAT_VERSION)
    arrays["meta:config"] = np.frombuffer(_fingerprint(cfg).encode(),
                                          dtype=np.uint8)
    _atomic_npz(path, arrays)


@_archive_guard
def restore(path: str, cfg: CommunityConfig, fresh_candidates: bool = False,
            device="cuda") -> PeerState:
    """Load an archive written by either package's ``save`` onto
    ``device`` (``"cuda"`` unless the caller asks for the CPU; no
    fallback without a card).  Raises :class:`CheckpointError` on a
    version or config mismatch, a missing leaf, a shape or dtype
    conflict, a failed CRC, a torn file, or a fleet archive."""
    dev = resolve_device(device)
    template = init_state(cfg, 0, device=dev)
    with _np_load(path) as z:
        version = int(z["meta:version"])
        if version not in _ACCEPTED_VERSIONS:
            raise CheckpointError(f"checkpoint format {version}, "
                                  f"expected {FORMAT_VERSION}")
        if "meta:replicas" in z:
            raise CheckpointError(
                "this is a FLEET archive (meta:replicas = "
                f"{int(z['meta:replicas'])}); the port reads single-run "
                "archives only")
        stored = bytes(z["meta:config"]).decode()
        want_fp = _want_fingerprint(cfg, version)
        if stored != want_fp:
            raise CheckpointError(
                "checkpoint was written under a different config:\n"
                f"  stored: {stored}\n  given:  {want_fp}")
        leaves = {}
        for n in leaf_names():
            t = _leaf(template, n)
            key = f"leaf:{n}"
            if key not in z:
                if _missing_ok(n, version):
                    leaves[n] = t
                    continue
                raise CheckpointError(f"checkpoint missing field {n}")
            arr = z[key]
            t_shape = tuple(t.shape)
            t_dtype = _np_dtype(t)
            if version >= 9:
                _verify_crc(z, key, arr, path)
            if version < 8:
                arr = _upconvert_v7(n, arr, t_dtype)
            if version < 14:
                arr = _resize_plane_leaf(n, arr, t_shape, t_dtype, path)
            if tuple(arr.shape) != t_shape or arr.dtype != t_dtype:
                raise CheckpointError(
                    f"field {n}: checkpoint {arr.shape}/{arr.dtype} vs "
                    f"config {t_shape}/{t_dtype}")
            leaves[n] = _to_torch(arr, dev)
    del template
    stats = Stats(**{k[len("stats/"):]: v for k, v in leaves.items()
                     if k.startswith("stats/")})
    state = PeerState(stats=stats, **{k: v for k, v in leaves.items()
                                      if not k.startswith("stats/")})
    if fresh_candidates:
        state = _wipe_ephemeral(state, cfg)
    return state


def _wipe_ephemeral(state: PeerState, cfg: CommunityConfig) -> PeerState:
    """An application restart on its database: the community-instance
    memory of every peer dies (candidates, forward buffer, blacklist,
    delay pen, signature cache); ``loaded`` comes back on for every peer
    under ``cfg.auto_load``, and otherwise keeps what the archive says
    (an explicit unload survives the restart)."""
    on = torch.ones(cfg.n_peers, dtype=torch.bool, device=state.device)
    state = wipe_instance_memory(state, on)
    return state.replace(loaded=on if cfg.auto_load else state.loaded)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True      # exists (or unknown): do not touch
    return True


def _clean_stale_tmps(path: str) -> None:
    """Remove ``{path}.tmp.<pid>`` files left by a saver that died between
    its write and its rename (only those whose pid is gone)."""
    for old in glob.glob(f"{path}.tmp.*"):
        try:
            pid = int(old.rsplit(".", 1)[-1])
        except ValueError:
            continue
        if pid != os.getpid() and _pid_alive(pid):
            continue
        try:
            os.remove(old)
        except OSError:
            pass


def _atomic_npz(path: str, arrays: dict) -> None:
    """``savez_compressed`` into a pid-unique temporary file, then
    ``os.replace`` onto ``path``; the temporary is removed on failure."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _clean_stale_tmps(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise

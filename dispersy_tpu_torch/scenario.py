"""Scenario driver: scripted timelines over the overlay (port of
``dispersy_tpu/scenario.py`` and of its command line, ``tools/scenario.py``).

Events act on peer masks at round boundaries -- publish, permission
grants and revokes, undo, dynamic flips, identities, destroy, unload and
load, fault / recovery / overload swaps, checkpoints -- and the runner
logs one metrics row a round (:class:`metrics.MetricsLog`) with the
coverage ``cov_<label>`` of each tracked record.  Event-free spans run
as one ``engine.multi_step`` with the telemetry ring drained once
(:func:`_ring_chunk`).  With ``autosave_every`` the runner checkpoints
(:mod:`checkpoint`) with a JSON sidecar, and ``run(..., resume=True)``
restarts from the latest valid snapshot and ends bit-identical to an
uninterrupted run.  The seed takes the place of the JAX package's key:
``init_state(cfg, seed)`` equals ``init_state(cfg, PRNGKey(seed))``.

    sc = Scenario(rounds=40, events=[
        (0,  Create(meta=1, authors=[5], payload=42, track="post")),
        (10, SetFault(churn_rate=0.05)),
        (20, Authorize(members=[5], metas=0b10)),
        (30, Destroy()),
    ])
    state, log = run(cfg, sc, device="cpu")

or from a JSON file::

    python -m dispersy_tpu_torch.scenario examples/flood.json --out run.json

which writes the same artifact as ``tools/scenario.py`` and runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from dispersy_tpu_torch import checkpoint as ckpt
from dispersy_tpu_torch import engine
from dispersy_tpu_torch import faults as flts
from dispersy_tpu_torch.config import (META_AUTHORIZE, META_DESTROY,
                                       META_DYNAMIC, META_REVOKE,
                                       META_UNDO_OTHER, META_UNDO_OWN,
                                       CommunityConfig, perm_mask)
from dispersy_tpu_torch.exceptions import CheckpointError
from dispersy_tpu_torch.metrics import MetricsLog
from dispersy_tpu_torch.state import PeerState, init_state
from dispersy_tpu_torch.u32 import MASK

logger = logging.getLogger(__name__)

AUTOSAVE_PREFIX = "auto" + "_"   # autosave file stem: auto_<round>.npz


def _mask(cfg: CommunityConfig, peers, dev) -> torch.Tensor:
    """int | sequence of ints | bool array -> bool [N] on ``dev``."""
    if isinstance(peers, (int, np.integer)):
        return torch.arange(cfg.n_peers, device=dev) == int(peers)
    arr = np.asarray(peers)
    if arr.dtype != bool:
        m = np.zeros(cfg.n_peers, bool)
        m[arr.astype(np.int64)] = True
        arr = m
    return torch.from_numpy(arr).to(dev)


def _full(cfg: CommunityConfig, value, dev) -> torch.Tensor:
    return torch.full((cfg.n_peers,), int(value), dtype=torch.int64,
                      device=dev)


def _clock(state: PeerState, row: int) -> int:
    """Peer ``row``'s global time on the host."""
    return int(state.global_time[row:row + 1].view(torch.int32).item()) & MASK


@dataclasses.dataclass
class Create:
    """App-level publish (scenarioscript's per-peer publish events)."""
    meta: int
    authors: object
    payload: int = 0
    aux: int = 0
    track: str | None = None  # label: per-round coverage of this record


@dataclasses.dataclass
class TrackRecord:
    """Register an existing record ``(author, gt)`` for on-device
    dissemination tracing (``engine.track_record``).  Requires ``cfg.trace.enabled``; peers
    already holding the record at registration are attributed to the
    create channel, so schedule it at (or right after) the record's
    creation — ``Create(track=...)`` does exactly that automatically
    when the trace plane is on.  Unlike ``Create.track``'s host-query
    fallback, a TrackRecord label's coverage curve always comes from
    the telemetry rows (``trace_cov_<slot> / alive_members``), so
    tracked runs keep the batched ring fast path."""
    label: str
    author: int
    gt: int


@dataclasses.dataclass
class SignatureRequest:
    """Open double-signed drafts author -> counterparty."""
    meta: int
    authors: object
    counterparty: int
    payload: int = 0


@dataclasses.dataclass
class Authorize:
    """Grant permissions for the metas in the ``metas`` bitmask to
    `members`.  ``perms`` names which of the reference's four permission
    types each meta bit conveys ("permit" / "authorize" / "revoke" /
    "undo" — timeline.py's quadruple; "authorize" lets the target extend
    the chain).  ``by`` picks the granting member (default: the
    founder); a non-founder granter must hold the authorize authority
    for every named meta or the engine's author gate refuses the create,
    exactly like a live overlay."""
    members: Sequence[int]
    metas: int
    perms: Sequence[str] = ("permit",)
    by: int | None = None


@dataclasses.dataclass
class Revoke:
    """Remove the named permissions; a non-founder ``by`` must hold the
    REVOKE authority (separable from authorize) on every named meta."""
    members: Sequence[int]
    metas: int
    perms: Sequence[str] = ("permit",)
    by: int | None = None


@dataclasses.dataclass
class Undo:
    """Mark (member, gt) undone; own=True means the author undoes itself,
    else ``by`` (default: the founder; a non-founder needs the UNDO
    permission on the target's meta) undoes it."""
    member: int
    gt: int
    own: bool = True
    by: int | None = None


@dataclasses.dataclass
class DynamicSettings:
    """Founder flips user meta `meta` to Linear (linear=True) or Public."""
    meta: int
    linear: bool


@dataclasses.dataclass
class Identity:
    """Masked members publish dispersy-identity records (crypto.py
    create_identities: payload = mid32 from the member registry; the
    scenario's registry is derived from the config's peer count).
    ``peers=None`` = every non-tracker member — see create_identities'
    caveat about mass same-gt joins saturating the Bloom slice."""
    peers: object = None


@dataclasses.dataclass
class Destroy:
    """Founder hard-kills the community."""


@dataclasses.dataclass
class SetFault:
    """Swap the fault model mid-run (a config change).

    ``None`` leaves a knob unchanged.  Beyond the original churn/loss
    pair, every chaos-harness knob (``planes.FaultModel``) can be
    swapped: Gilbert-Elliott burst parameters, region
    partitions (heal a netsplit by passing ``partitions=()``),
    duplication/corruption rates, byzantine flooders, and the health
    sentinels.  Knob flips that enable/disable a whole subsystem
    resize its state leaves via ``faults.adapt_state`` (enabling
    starts clean; disabling discards the latch/counter)."""
    churn_rate: float | None = None
    packet_loss: float | None = None
    ge_p_bad: float | None = None
    ge_p_good: float | None = None
    ge_loss_good: float | None = None
    ge_loss_bad: float | None = None
    partitions: tuple | None = None
    dup_rate: float | None = None
    corrupt_rate: float | None = None
    flood_senders: tuple | None = None
    flood_fanout: int | None = None
    health_checks: bool | None = None
    health_drop_limit: int | None = None


_FAULT_KNOBS = ("ge_p_bad", "ge_p_good", "ge_loss_good", "ge_loss_bad",
                "partitions", "dup_rate", "corrupt_rate", "flood_senders",
                "flood_fanout", "health_checks", "health_drop_limit")


@dataclasses.dataclass
class SetRecovery:
    """Swap the recovery plane mid-run (a config change;
    ``planes.RecoveryConfig`` -- the ``SetFault`` shape).

    ``None`` leaves a knob unchanged.  Flipping ``enabled`` across the
    boundary resizes the recovery state leaves via
    ``recovery.adapt_state`` (enabling starts clean; disabling discards
    backoff/quarantine/repair history and the action counters).  The
    applied flips are recorded in the autosave JSON sidecar
    (``recovery_history``) so ``run(resume=True)`` replays them even
    when the resume straddles the flip round."""
    enabled: bool | None = None
    soft_repair: bool | None = None
    backoff_limit: int | None = None
    backoff_decay: float | None = None
    quarantine_rounds: int | None = None
    requarantine_window: int | None = None


_RECOVERY_KNOBS = ("enabled", "soft_repair", "backoff_limit",
                   "backoff_decay", "quarantine_rounds",
                   "requarantine_window")


def _setrecovery_kw(ev: "SetRecovery") -> dict:
    return {k: getattr(ev, k) for k in _RECOVERY_KNOBS
            if getattr(ev, k) is not None}


def _setrecovery_cfg(cfg: CommunityConfig,
                     ev: "SetRecovery") -> CommunityConfig:
    """The pure config half of a SetRecovery — shared by the live event
    interpreter and the resume-time replay (run())."""
    kw = _setrecovery_kw(ev)
    return cfg.replace(recovery=cfg.recovery.replace(**kw)) if kw else cfg


@dataclasses.dataclass
class SetOverload:
    """Swap the ingress-protection plane mid-run (a config change;
    ``planes.OverloadConfig`` -- the ``SetRecovery`` shape).

    ``None`` leaves a knob unchanged.  Flipping ``enabled`` across the
    boundary resizes the overload state leaves via
    ``overload.adapt_state`` (enabling starts with empty buckets and
    zero shed counters; disabling discards).  The applied flips are
    recorded in the autosave JSON sidecar (``overload_history``) so
    ``run(resume=True)`` replays them even when the resume straddles
    the flip round."""
    enabled: bool | None = None
    priority_admission: bool | None = None
    bucket_rate: float | None = None
    bucket_depth: int | None = None


_OVERLOAD_KNOBS = ("enabled", "priority_admission", "bucket_rate",
                   "bucket_depth")


def _setoverload_kw(ev: "SetOverload") -> dict:
    return {k: getattr(ev, k) for k in _OVERLOAD_KNOBS
            if getattr(ev, k) is not None}


def _setoverload_cfg(cfg: CommunityConfig,
                     ev: "SetOverload") -> CommunityConfig:
    """The pure config half of a SetOverload — shared by the live event
    interpreter and the resume-time replay (run())."""
    kw = _setoverload_kw(ev)
    return cfg.replace(overload=cfg.overload.replace(**kw)) if kw else cfg


def _deep_tuple(v):
    """JSON lists -> tuples, recursively (config fields stay hashable)."""
    if isinstance(v, (list, tuple)):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _setfault_cfg(cfg: CommunityConfig, ev: "SetFault") -> CommunityConfig:
    """The pure config half of a SetFault — shared by the live event
    interpreter and the resume-time config replay (run())."""
    kw = {}
    if ev.churn_rate is not None:
        kw["churn_rate"] = ev.churn_rate
    if ev.packet_loss is not None:
        kw["packet_loss"] = ev.packet_loss
    fkw = {k: _deep_tuple(getattr(ev, k)) for k in _FAULT_KNOBS
           if getattr(ev, k) is not None}
    if fkw:
        kw["faults"] = cfg.faults.replace(**fkw)
    return cfg.replace(**kw) if kw else cfg


@dataclasses.dataclass
class Unload:
    """Unload `members`' community instances (reference:
    Community.unload_community): they stop walking, serving, and taking
    records in; their candidate tables, delay pens, and signature caches
    — community-instance memory — are freed, while the store (the
    database) persists.  Tracker rows are silently excluded: the
    reference's TrackerCommunity auto-joins any community generically
    and has no unload path (tool/tracker.py).  With cfg.auto_load (the reference's
    define_auto_load default) any later community packet re-loads them;
    otherwise only an explicit Load event does.  Routed through
    ``engine.unload_members``, which also clears the forward buffer and
    the blacklist."""
    members: Sequence[int]


@dataclasses.dataclass
class Load:
    """Explicitly re-load `members`' community instances (reference:
    Dispersy.get_community(load=True) / Community.load_community).  A
    re-loaded peer re-walks from the trackers — candidates were not
    persisted, exactly the reference's restart rule."""
    members: Sequence[int]


@dataclasses.dataclass
class Checkpoint:
    path: str


@dataclasses.dataclass
class Scenario:
    rounds: int
    events: Sequence[tuple]          # (round, event) pairs
    seed_degree: int | None = 8
    snapshot_every: int = 1
    # Crash-resume: every `autosave_every` rounds the runner checkpoints
    # the state (a CRC-protected single-run archive, checkpoint.py) and a
    # JSON sidecar (metrics rows, tracked records, applied SetRecovery /
    # SetOverload flips, next round) into `autosave_dir`;
    # run(..., resume=True) restarts from the latest snapshot that
    # passes its checks -- a corrupt or torn autosave is rejected with
    # CheckpointError and the previous one is used.  0 = off.
    autosave_every: int = 0
    autosave_dir: str | None = None


def _apply(state: PeerState, cfg: CommunityConfig, ev, tracked: dict,
           ctx: dict, trace_slots: dict | None = None, rnd: int = 0):
    trace_slots = trace_slots if trace_slots is not None else {}
    founder = cfg.founder
    dev = state.device
    if isinstance(ev, TrackRecord):
        # The label's coverage rides the telemetry rows.
        if not cfg.trace.enabled:
            raise ValueError(
                f"TrackRecord({ev.label!r}) requires cfg.trace.enabled "
                "(the dissemination-tracing plane)")
        state, slot = engine.track_record(state, cfg, int(ev.author),
                                          int(ev.gt))
        trace_slots[ev.label] = (slot, rnd)
        return state, cfg
    if isinstance(ev, Create):
        m = _mask(cfg, ev.authors, dev)
        authors = np.flatnonzero(m.cpu().numpy())
        if ev.track is not None and len(authors) == 0:
            raise ValueError(
                f"Create(track={ev.track!r}) has an empty author set -- "
                "nothing to track")
        gt_before = _clock(state, int(authors[0])) if len(authors) else 0
        state = engine.create_messages(state, cfg, m, ev.meta,
                                       _full(cfg, ev.payload, dev),
                                       _full(cfg, ev.aux, dev))
        if ev.track is not None:
            author = int(authors[0])
            gt_after = _clock(state, author)
            if gt_after == gt_before:
                # The timeline gate refused the creation: a coverage
                # curve of nothing would be worse than failing.
                raise ValueError(
                    f"Create(track={ev.track!r}): author {author}'s "
                    f"creation of meta {ev.meta} was refused by the "
                    "timeline gate -- reorder the scenario's events")
            tracked[ev.track] = (author, gt_after, ev.meta, ev.payload)
            if cfg.trace.enabled:
                # The label's coverage comes from the on-device lineage;
                # when every slot is taken it falls back to a store
                # query a round.
                try:
                    state, slot = engine.track_record(state, cfg,
                                                      author, gt_after)
                except ValueError:
                    logger.warning(
                        "Create(track=%r): all %d trace.tracked_slots "
                        "taken -- label falls back to per-round host "
                        "store queries (off the ring fast path)",
                        ev.track, cfg.trace.tracked_slots)
                else:
                    trace_slots[ev.track] = (slot, rnd)
    elif isinstance(ev, SignatureRequest):
        state = engine.create_signature_request(
            state, cfg, _mask(cfg, ev.authors, dev), ev.meta,
            _full(cfg, ev.counterparty, dev), _full(cfg, ev.payload, dev))
    elif isinstance(ev, (Authorize, Revoke)):
        meta = META_AUTHORIZE if isinstance(ev, Authorize) else META_REVOKE
        granter = founder if ev.by is None else ev.by
        nibbles = perm_mask([(k, p) for k in range(32)
                             if (ev.metas >> k) & 1 for p in ev.perms])
        for member in ev.members:   # one record per target member
            state = engine.create_messages(
                state, cfg, _mask(cfg, granter, dev), meta,
                _full(cfg, member, dev), _full(cfg, nibbles, dev))
    elif isinstance(ev, Undo):
        meta = META_UNDO_OWN if ev.own else META_UNDO_OTHER
        author = ev.member if ev.own else (
            founder if ev.by is None else ev.by)
        state = engine.create_messages(
            state, cfg, _mask(cfg, author, dev), meta,
            _full(cfg, ev.member, dev), _full(cfg, ev.gt, dev))
    elif isinstance(ev, DynamicSettings):
        state = engine.create_messages(
            state, cfg, _mask(cfg, founder, dev), META_DYNAMIC,
            _full(cfg, ev.meta, dev), _full(cfg, int(ev.linear), dev))
    elif isinstance(ev, Identity):
        from dispersy_tpu_torch import crypto
        # One registry per run: derived members are cached across events.
        registry = ctx.setdefault("registry", crypto.MemberRegistry())
        state = crypto.create_identities(
            state, cfg, registry,
            mask=None if ev.peers is None else _mask(cfg, ev.peers, dev))
    elif isinstance(ev, Destroy):
        state = engine.create_messages(
            state, cfg, _mask(cfg, founder, dev), META_DESTROY,
            _full(cfg, 0, dev))
    elif isinstance(ev, Unload):
        m = np.isin(np.arange(cfg.n_peers), list(ev.members))
        state = engine.unload_members(state, cfg, torch.from_numpy(m).to(dev))
    elif isinstance(ev, Load):
        m = np.isin(np.arange(cfg.n_peers), list(ev.members))
        state = engine.load_members(state, torch.from_numpy(m).to(dev))
    elif isinstance(ev, SetFault):
        new_cfg = _setfault_cfg(cfg, ev)
        # A flip across a subsystem's enablement resizes its leaves.
        state = flts.adapt_state(state, cfg, new_cfg)
        cfg = new_cfg
    elif isinstance(ev, SetRecovery):
        from dispersy_tpu_torch import recovery as rcv
        new_cfg = _setrecovery_cfg(cfg, ev)
        state = rcv.adapt_state(state, cfg, new_cfg)
        cfg = new_cfg
    elif isinstance(ev, SetOverload):
        from dispersy_tpu_torch import overload as ovl
        new_cfg = _setoverload_cfg(cfg, ev)
        state = ovl.adapt_state(state, cfg, new_cfg)
        cfg = new_cfg
    elif isinstance(ev, Checkpoint):
        ckpt.save(ev.path, state, cfg)
    else:
        raise TypeError(f"unknown scenario event {ev!r}")
    return state, cfg


def _autosave(dirpath: str, next_round: int, state: PeerState,
              cfg: CommunityConfig, tracked: dict, log: MetricsLog,
              recovery_hist: list | None = None,
              overload_hist: list | None = None,
              trace_slots: dict | None = None) -> None:
    """One crash-resume snapshot: CRC-protected state archive + a JSON
    sidecar carrying everything the runner itself holds (metrics rows,
    tracked-record specs, the round to resume at, and the applied
    SetRecovery/SetOverload flips so resume replays the config
    history).  Both writes are atomic (tmp + replace), so a crash
    mid-autosave leaves the previous snapshot intact and the torn one
    detectably invalid."""
    os.makedirs(dirpath, exist_ok=True)
    base = os.path.join(dirpath, f"{AUTOSAVE_PREFIX}{next_round:06d}")
    ckpt.save(base + ".npz", state, cfg)
    doc = {"next_round": next_round,
           "tracked": {k: list(v) for k, v in tracked.items()},
           "trace_slots": {k: list(v)
                           for k, v in (trace_slots or {}).items()},
           "recovery_history": list(recovery_hist or ()),
           "overload_history": list(overload_hist or ()),
           "meta": log.meta, "rows": log.rows}
    # The archive's temporary-file hygiene: sweep orphans of crashed
    # savers, unlink our own temporary on any failure.
    ckpt._clean_stale_tmps(base + ".json")
    tmp = f"{base}.json.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, base + ".json")
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _cfg_at_round(cfg: CommunityConfig, by_round: dict, upto: int,
                  recovery_history: list | None = None,
                  overload_history: list | None = None
                  ) -> CommunityConfig:
    """Replay the schedule's config-affecting events (SetFault /
    SetRecovery / SetOverload) for rounds < ``upto``: the config a
    snapshot taken after round ``upto - 1`` was saved under.  Pure — no
    state is touched.  When an autosave sidecar's ``recovery_history``
    / ``overload_history`` is given it is the authority for that
    plane's flips (the flips that actually ran), applied instead of
    scanning ``by_round`` for the matching event type."""
    for rnd in sorted(r for r in by_round if r < upto):
        for ev in by_round[rnd]:
            if isinstance(ev, SetFault):
                cfg = _setfault_cfg(cfg, ev)
            elif isinstance(ev, SetRecovery) and recovery_history is None:
                cfg = _setrecovery_cfg(cfg, ev)
            elif isinstance(ev, SetOverload) and overload_history is None:
                cfg = _setoverload_cfg(cfg, ev)
    for rnd, kw in (recovery_history or ()):
        if rnd < upto:
            cfg = cfg.replace(recovery=cfg.recovery.replace(**kw))
    for rnd, kw in (overload_history or ()):
        if rnd < upto:
            cfg = cfg.replace(overload=cfg.overload.replace(**kw))
    return cfg


def _load_latest_autosave(dirpath: str, cfg0: CommunityConfig,
                          by_round: dict, device="cuda"):
    """Newest-first scan of the autosave directory; returns
    ``(state, cfg, next_round, sidecar)`` from the latest snapshot whose
    archive passes the CRC/config checks, or None when no usable
    snapshot exists.  Corrupt/torn snapshots (CheckpointError) are
    logged and SKIPPED — never silently restored — so a crash during
    autosave falls back to the previous good one.  ``*.tmp.*`` leftovers
    never match the ``.npz`` glob."""
    import glob as _glob

    def _snap_round(path: str) -> int:
        stem = os.path.basename(path)[len(AUTOSAVE_PREFIX):-len(".npz")]
        return int(stem) if stem.isdigit() else -1

    snaps = sorted(_glob.glob(os.path.join(
        dirpath, AUTOSAVE_PREFIX + "*.npz")), key=_snap_round, reverse=True)
    for path in snaps:
        sidecar = path[:-len(".npz")] + ".json"
        try:
            with open(sidecar) as f:
                doc = json.load(f)
            next_round = int(doc["next_round"])
            cfg = _cfg_at_round(cfg0, by_round, next_round,
                                doc.get("recovery_history"),
                                doc.get("overload_history"))
            state = ckpt.restore(path, cfg, device=device)
        except (CheckpointError, OSError, ValueError, KeyError) as e:
            logger.warning("autosave %s unusable (%s: %s); falling back "
                           "to the previous snapshot", path,
                           type(e).__name__, e)
            continue
        return state, cfg, next_round, doc
    return None


def _ring_chunk(cfg: CommunityConfig, scenario: Scenario, by_round: dict,
                tracked: dict, rnd: int,
                trace_slots: dict | None = None) -> int:
    """Rounds batchable through ``engine.multi_step`` and one ring drain,
    starting at ``rnd`` (1 = take the per-round path).

    Batchable only when the telemetry ring holds every skipped round,
    the log takes every round (snapshot_every=1), every tracked coverage
    curve comes from the row (its label holds a trace slot; a label
    without one needs a store query each round), and the span crosses
    no scheduled event.  An autosave boundary bounds the chunk."""
    h = cfg.telemetry.history
    host_tracked = [lbl for lbl in tracked
                    if lbl not in (trace_slots or {})]
    if h <= 1 or scenario.snapshot_every != 1 or host_tracked:
        return 1
    limit = min(h, scenario.rounds - rnd)
    for k in range(1, limit):
        if (rnd + k) in by_round:
            limit = k
            break
    if scenario.autosave_every:
        limit = min(limit,
                    scenario.autosave_every - rnd % scenario.autosave_every)
    return max(limit, 1)


def _attach_trace_covs(row: dict, trace_slots: dict) -> None:
    """Derive ``cov_<label>`` for every trace-registered label from the
    row's on-device coverage words: ``trace_cov_<slot> /
    max(alive_members, 1)`` in float32 -- the f32 division
    ``engine.coverage`` computes (the two curves agree while no tracked
    record is evicted from a ring: lineage is arrival history, the host
    query current residency).  Rows from before a label's registration
    round carry no key for it."""
    for label, (slot, reg_rnd) in trace_slots.items():
        if int(row.get("round", 0)) <= int(reg_rnd):
            continue
        cov = row.get(f"trace_cov_{slot}")
        if cov is None:
            continue
        alive = max(int(row.get("alive_members", 0)), 1)
        row[f"cov_{label}"] = float(np.float32(cov) / np.float32(alive))


def run(cfg: CommunityConfig, scenario: Scenario, seed: int = 0,
        log: MetricsLog | None = None, resume: bool = False,
        device="cuda") -> tuple[PeerState, MetricsLog]:
    """Execute the scenario; returns the final state and the metrics log.

    Every logged row carries ``cov_<label>`` for each tracked record —
    the convergence curves the reference's experiment pipeline mined from
    its logs.

    With ``resume=True`` (and ``scenario.autosave_dir`` populated by an
    earlier autosaving run) execution restarts from the latest valid
    snapshot and the finished run is bit-identical -- final state and
    metrics log -- to an uninterrupted one: restore is the byte-exact
    ``fresh_candidates=False`` mode, the RNG key and round ride in the
    archive, and the sidecar restores the metrics rows and tracked
    records (JSON round-trips Python floats exactly).  Runs on
    ``device`` (``"cuda"`` unless the caller asks for the CPU; no
    fallback without a card).
    """
    log = log or MetricsLog(meta={"scenario_rounds": scenario.rounds})
    by_round: dict[int, list] = {}
    for rnd, ev in scenario.events:
        if not (0 <= int(rnd) < scenario.rounds):
            # A skipped event would make the artifact describe another
            # experiment than the file.
            raise ValueError(
                f"event {ev!r} scheduled at round {rnd}, outside the "
                f"scenario's [0, {scenario.rounds}) range")
        if isinstance(ev, Identity) and not cfg.identity_enabled:
            # Fail before round 0, not at the event's round.
            raise ValueError(
                f"Identity event at round {rnd} requires "
                "config.identity_enabled=True")
        by_round.setdefault(int(rnd), []).append(ev)
    if scenario.autosave_every and not scenario.autosave_dir:
        raise ValueError("autosave_every requires autosave_dir")
    tracked: dict[str, tuple] = {}
    trace_slots: dict[str, tuple] = {}   # label -> (slot, reg round)
    ctx: dict = {}
    recovery_hist: list = []   # applied SetRecovery flips: [round, kw]
    overload_hist: list = []   # applied SetOverload flips: [round, kw]
    start_round = 0
    state = None
    if resume:
        if not scenario.autosave_dir:
            raise ValueError("resume=True requires scenario.autosave_dir")
        got = _load_latest_autosave(scenario.autosave_dir, cfg, by_round,
                                    device)
        if got is not None:
            state, cfg, start_round, doc = got
            tracked = {k: tuple(v) for k, v in doc["tracked"].items()}
            trace_slots = {k: (int(v[0]), int(v[1])) for k, v in
                           doc.get("trace_slots", {}).items()}
            recovery_hist = [[int(r), dict(kw)] for r, kw in
                             doc.get("recovery_history", ())]
            overload_hist = [[int(r), dict(kw)] for r, kw in
                             doc.get("overload_history", ())]
            log.meta = doc.get("meta", log.meta)
            log.rows = list(doc.get("rows", ()))
            logger.info("resuming scenario at round %d from %s",
                        start_round, scenario.autosave_dir)
    if state is None:
        state = init_state(cfg, seed, device=device)
        if scenario.seed_degree:
            state = engine.seed_overlay(state, cfg, scenario.seed_degree)

    rnd = start_round
    while rnd < scenario.rounds:
        for ev in by_round.get(rnd, ()):
            state, cfg = _apply(state, cfg, ev, tracked, ctx,
                                trace_slots, rnd)
            if isinstance(ev, SetRecovery):
                # Record the applied flip for the autosave sidecar so a
                # resume that straddles it replays the same config.
                recovery_hist.append([rnd, _setrecovery_kw(ev)])
            elif isinstance(ev, SetOverload):
                overload_hist.append([rnd, _setoverload_kw(ev)])
        # With a telemetry ring and nothing needing a per-round host
        # visit, an event-free span runs as one multi_step and its rows
        # drain from the ring in one transfer.
        chunk = _ring_chunk(cfg, scenario, by_round, tracked, rnd,
                            trace_slots)
        if chunk > 1:
            state = engine.multi_step(state, cfg, chunk)
            for row in log.extend_from_ring(state, cfg):
                _attach_trace_covs(row, trace_slots)
            rnd += chunk
        else:
            state = engine.step(state, cfg)
            if rnd % scenario.snapshot_every == 0:
                # Store queries only for labels without a trace slot
                # (_attach_trace_covs reads the others from the row).
                covs = {f"cov_{label}": float(engine.coverage(state, *spec))
                        for label, spec in tracked.items()
                        if label not in trace_slots}
                row = log.append(state, cfg, **covs)
                _attach_trace_covs(row, trace_slots)
            rnd += 1
        if scenario.autosave_every and rnd % scenario.autosave_every == 0:
            _autosave(scenario.autosave_dir, rnd, state, cfg,
                      tracked, log, recovery_hist, overload_hist,
                      trace_slots)
    return state, log

# ---- the command line (tools/scenario.py's) --------------------------------

EVENT_TYPES = {
    "create": Create,
    "track_record": TrackRecord,
    "signature_request": SignatureRequest,
    "authorize": Authorize,
    "revoke": Revoke,
    "undo": Undo,
    "dynamic_settings": DynamicSettings,
    "identity": Identity,
    "destroy": Destroy,
    "set_fault": SetFault,
    "set_recovery": SetRecovery,
    "set_overload": SetOverload,
    "unload": Unload,
    "load": Load,
    "checkpoint": Checkpoint,
}


def _tuplize(v):
    """JSON lists -> tuples, recursively (tuple-typed config knobs)."""
    if isinstance(v, list):
        return tuple(_tuplize(x) for x in v)
    return v


def load(path: str) -> tuple[CommunityConfig, Scenario]:
    """A scenario JSON file (``tools/scenario.py``'s shape: ``config``,
    ``rounds``, ``seed_degree``, ``events``, ...) as a config and a
    :class:`Scenario`; a plane's sub-config dict builds its class."""
    from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                           RecoveryConfig, StoreConfig,
                                           TelemetryConfig, TraceConfig)
    with open(path) as f:
        doc = json.load(f)
    ckw = {k: _tuplize(v) for k, v in doc.get("config", {}).items()}
    for key, cls in (("faults", FaultModel), ("overload", OverloadConfig),
                     ("recovery", RecoveryConfig), ("store", StoreConfig),
                     ("telemetry", TelemetryConfig), ("trace", TraceConfig)):
        if isinstance(ckw.get(key), dict):
            ckw[key] = cls(**{k: _tuplize(v) for k, v in ckw[key].items()})
    cfg = CommunityConfig(**ckw)
    events = []
    for e in doc.get("events", ()):
        e = dict(e)
        rnd = e.pop("round")
        cls = EVENT_TYPES[e.pop("type")]
        events.append((rnd, cls(**e)))
    return cfg, Scenario(rounds=doc["rounds"], events=events,
                         seed_degree=doc.get("seed_degree", 8),
                         snapshot_every=doc.get("snapshot_every", 1),
                         autosave_every=doc.get("autosave_every", 0),
                         autosave_dir=doc.get("autosave_dir"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m dispersy_tpu_torch.scenario",
        description="Run a scenario JSON file; print the last metrics row.")
    ap.add_argument("scenario", help="scenario JSON file")
    ap.add_argument("--out", default=None, help="metrics artifact path")
    ap.add_argument("--autosave-every", type=int, default=None,
                    help="checkpoint every N rounds (overrides the "
                         "scenario file's autosave_every)")
    ap.add_argument("--autosave-dir", default=None,
                    help="autosave directory (overrides the scenario "
                         "file's autosave_dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest valid autosave in the "
                         "autosave directory; finishes bit-identically "
                         "to an uninterrupted run")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    cfg, sc = load(args.scenario)
    if args.autosave_every is not None:
        sc = dataclasses.replace(sc, autosave_every=args.autosave_every)
    if args.autosave_dir is not None:
        sc = dataclasses.replace(sc, autosave_dir=args.autosave_dir)
    _, log = run(cfg, sc, resume=args.resume, device=args.device)
    if args.out:
        log.dump(args.out)
    last = log.rows[-1] if log.rows else {}
    print(json.dumps({k: v for k, v in last.items()
                      if not isinstance(v, list)}))


if __name__ == "__main__":
    main()

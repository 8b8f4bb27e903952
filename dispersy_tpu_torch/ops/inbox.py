"""The delivery ops: UDP datagrams as a sort-by-receiver scatter (port of
``dispersy_tpu/ops/inbox.py``).

Every logical packet of a round is an edge (destination, payload
columns).  Delivery groups edges by destination in edge order -- or, with
the overload plane's admission classes, in (class, edge) order -- gives
each its rank in the group, and scatters ranks < Q into bounded
``[N, Q]`` inboxes; the rest are dropped and counted per destination.
Invalid or out-of-range destinations park (never delivered, never
counted).

:func:`deliver_ragged` is the same delivery restructured for a peer axis
split into ``shards``: each shard sorts its own slice of the edge list,
fills per-destination-shard send buckets of at most ``budget`` entries
(shedding the rest at the sender), and the buckets cross in one
source <-> destination transpose before each shard lands its arrivals.

Both are wrappers: a CPU tensor takes the plain version (sorts on packed
keys, following the JAX function step by step), a CUDA tensor the
hand-written kernel (``csrc/deliver.cu``, ``csrc/ragged.cu``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.u32 import bits, unbits


class Delivery(NamedTuple):
    inbox: tuple               # one [N, Q, ...] tensor per payload column
    inbox_valid: torch.Tensor  # bool[N, Q]
    n_dropped: torch.Tensor    # i32[N] packets lost to inbox overflow
    edge_slot: torch.Tensor    # i32[E] slot each edge landed in, -1 if not


class RaggedDelivery(NamedTuple):
    delivery: Delivery         # exactly :func:`deliver`'s contract
    shed: torch.Tensor         # bool[E] lost to a full send bucket


def _lexsort(keys, dim: int = -1) -> torch.Tensor:
    """Indices sorting along ``dim`` by ``keys`` (first key primary), ties
    kept in index order: stable sorts from the last key to the first."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else torch.gather(perm, dim, order)
    return perm


def _group_rank(skey: torch.Tensor) -> torch.Tensor:
    """Each entry's rank within its run of equal ``skey`` along the last
    dimension (the cummax-scan form)."""
    iota = torch.arange(skey.shape[-1], device=skey.device).expand_as(skey)
    is_start = torch.ones_like(skey, dtype=torch.bool)
    is_start[..., 1:] = skey[..., 1:] != skey[..., :-1]
    first = torch.cummax(torch.where(is_start, iota, 0), dim=-1).values
    return iota - first


def _land(cols, flat, kept, size: int, shape: tuple):
    """Scatter the kept entries of each column to flat index ``flat`` of
    a zero buffer of ``size`` rows, reshaped to ``shape``."""
    dev = flat.device
    inbox = []
    for c in cols:
        out = torch.zeros((size,) + tuple(c.shape[1:]), dtype=bits(c).dtype,
                          device=dev)
        out[flat] = bits(c)[kept]
        inbox.append(unbits(out, c.dtype).reshape(shape + tuple(c.shape[1:])))
    valid = torch.zeros(size, dtype=torch.bool, device=dev)
    valid[flat] = True
    return tuple(inbox), valid.reshape(shape)


def deliver_plain(dst, cols, valid, n_peers: int, inbox_size: int,
                  cls=None) -> Delivery:
    e = dst.shape[0]
    dev = dst.device
    q = inbox_size
    ok = valid & (dst >= 0) & (dst < n_peers)
    key = torch.where(ok, dst.to(torch.int64), n_peers)
    pos = torch.arange(e, dtype=torch.int64, device=dev)
    # One packed int64 key: (destination, class, position).
    span = max(e, 1)
    c = 0 if cls is None else cls.to(torch.int64)
    spos = torch.sort((key * 256 + c) * span + pos).values % span
    skey = key[spos]
    slot = _group_rank(skey)
    keep = (skey < n_peers) & (slot < q)
    edge_slot = torch.empty(e, dtype=torch.int32, device=dev)
    edge_slot[spos] = torch.where(keep, slot, -1).to(torch.int32)
    kept = edge_slot >= 0
    flat = key[kept] * q + edge_slot[kept].to(torch.int64)
    inbox, inbox_valid = _land(cols, flat, kept, n_peers * q, (n_peers, q))
    n_dropped = torch.bincount(key[ok & ~kept], minlength=n_peers)[
        :n_peers].to(torch.int32)
    return Delivery(inbox=inbox, inbox_valid=inbox_valid,
                    n_dropped=n_dropped, edge_slot=edge_slot)


def deliver(dst: torch.Tensor, cols: Sequence[torch.Tensor],
            valid: torch.Tensor, n_peers: int, inbox_size: int,
            cls: torch.Tensor | None = None) -> Delivery:
    """Deliver an edge list into per-peer inboxes.

    ``dst``: i32[E]; ``cols``: payload columns [E] or [E, W] (u32, u16, u8
    or bool); ``valid``: bool[E]; ``cls``: optional u8[E] admission class
    (lower classes take the slots first).  Order within a destination is
    edge order, or (class, edge) order; ``edge_slot`` is each edge's
    receipt (its inbox slot, or -1).
    """
    if dst.device.type == "cpu":
        return deliver_plain(dst, cols, valid, n_peers, inbox_size, cls)
    inbox, inbox_valid, n_dropped, edge_slot = kernels.deliver(
        dst, cols, valid, n_peers, inbox_size, cls)
    return Delivery(tuple(inbox), inbox_valid, n_dropped, edge_slot)


def deliver_ragged_plain(dst, cols, valid, n_peers: int, inbox_size: int,
                         shards: int, budget: int = 0, cls=None,
                         need_receipts: bool = True) -> RaggedDelivery:
    """The JAX function's steps on the ``[S, El]`` view: the shard-local
    source sort, the capped buckets, the transpose, the destination merge,
    the shard-local landing and the receipts."""
    s, e, dev = shards, dst.shape[0], dst.device
    q = inbox_size
    nl = n_peers // s
    el = -(-e // s)
    ep = el * s
    if ep != e:
        pad = ep - e
        dst = torch.cat([dst, torch.zeros(pad, dtype=dst.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)])
        if cls is not None:
            cls = torch.cat([cls, torch.zeros(pad, dtype=cls.dtype,
                                              device=dev)])
        cols = [torch.cat([bits(c), torch.zeros((pad,) + tuple(c.shape[1:]),
                                                dtype=bits(c).dtype,
                                                device=dev)]).view(c.dtype)
                for c in cols]
    b = el if budget <= 0 else min(budget, el)
    ok = valid & (dst >= 0) & (dst < n_peers)
    key = torch.where(ok, dst.to(torch.int64), n_peers).reshape(s, el)
    lpos = torch.arange(el, device=dev).expand(s, el)
    c_all = (torch.zeros(ep, dtype=torch.int64, device=dev) if cls is None
             else cls.to(torch.int64)).reshape(s, el)

    # 2. the shard-local source sort by (destination, class, position).
    order = _lexsort([key, c_all, lpos])
    skey = torch.gather(key, 1, order)
    scls = torch.gather(c_all, 1, order)
    slpos = order

    # 3. destination-shard buckets, capped at b; "nowhere" is s * b.
    dsh = torch.where(skey < n_peers, skey // nl, s)
    rank = _group_rank(dsh)
    keep_src = (dsh < s) & (rank < b)
    shed_sorted = (dsh < s) & (rank >= b)
    rows = torch.arange(s, device=dev)[:, None]
    bidx = torch.where(keep_src, dsh * b + rank, s * b)

    def to_bucket(val, fill):
        out = torch.full((s, s * b + 1) + tuple(val.shape[2:]), fill,
                         dtype=val.dtype, device=dev)
        ix = bidx.reshape((s, el) + (1,) * (val.dim() - 2)).expand_as(val)
        out.scatter_(1, ix, val)
        return out[:, :s * b]

    gpos = rows * el + slpos
    bkey = to_bucket(skey, n_peers)
    bgpos = to_bucket(gpos, 0)
    bcls = to_bucket(scls, 0)
    bcols = []
    for c in cols:
        cr = bits(c).reshape((s, el) + tuple(c.shape[1:]))
        ix = slpos.reshape((s, el) + (1,) * (cr.dim() - 2)).expand_as(cr)
        bcols.append(to_bucket(torch.gather(cr, 1, ix), 0))

    # 4. the exchange: transpose source <-> destination shard.
    def exchange(buf):
        return (buf.reshape((s, s, b) + tuple(buf.shape[2:]))
                .transpose(0, 1).reshape((s, s * b) + tuple(buf.shape[2:])))
    xkey, xgpos, xcls = exchange(bkey), exchange(bgpos), exchange(bcls)
    xcols = [exchange(bc) for bc in bcols]

    # 5. the destination merge by (destination, class, global position),
    # ties (empty bucket entries) by exchange index; the landing.
    sei = _lexsort([xkey, xcls, xgpos])
    dkey = torch.gather(xkey, 1, sei)
    slot = _group_rank(dkey)
    real = dkey < n_peers
    keep_dst = real & (slot < q)
    entry_slot = torch.empty((s, s * b), dtype=torch.int64, device=dev)
    entry_slot.scatter_(1, sei, torch.where(keep_dst, slot, -1))
    landed = entry_slot >= 0
    lkey = xkey - rows * nl
    flat = ((rows * nl + lkey) * q + entry_slot)[landed]
    inbox, inbox_valid = _land(
        [unbits(x.reshape((s * s * b,) + tuple(x.shape[2:])), c.dtype)
         for x, c in zip(xcols, cols)], flat, landed.reshape(-1),
        n_peers * q, (n_peers, q))
    ovf = real & (slot >= q)
    n_dropped = torch.bincount(dkey[ovf], minlength=n_peers)[
        :n_peers].to(torch.int32)

    # 6. receipts and the sender-side shed, back in edge order.
    shed = torch.zeros((s, el), dtype=torch.bool, device=dev)
    shed.scatter_(1, slpos, shed_sorted)
    shed = shed.reshape(ep)[:e]
    if need_receipts:
        rslot = exchange(entry_slot)
        got = torch.gather(rslot, 1, torch.where(keep_src, bidx, 0))
        sslot = torch.where(keep_src, got, -1)
        edge_slot = torch.empty((s, el), dtype=torch.int64, device=dev)
        edge_slot.scatter_(1, slpos, sslot)
        edge_slot = edge_slot.reshape(ep)[:e].to(torch.int32)
    else:
        edge_slot = torch.full((e,), -1, dtype=torch.int32, device=dev)
    return RaggedDelivery(Delivery(inbox, inbox_valid, n_dropped, edge_slot),
                          shed)


def deliver_ragged(dst: torch.Tensor, cols: Sequence[torch.Tensor],
                   valid: torch.Tensor, n_peers: int, inbox_size: int,
                   shards: int, budget: int = 0,
                   cls: torch.Tensor | None = None,
                   need_receipts: bool = True) -> RaggedDelivery:
    """:func:`deliver` for a peer axis split ``shards`` ways: per
    (source shard, destination shard) bucket the first ``budget`` edges in
    (destination, class, position) order cross and the rest are shed at
    the sender (``shed``); ``budget=0`` never sheds and equals
    :func:`deliver`.  Without ``need_receipts`` every ``edge_slot`` is -1.
    ``n_peers`` must be a multiple of ``shards``."""
    if dst.device.type == "cpu":
        return deliver_ragged_plain(dst, cols, valid, n_peers, inbox_size,
                                    shards, budget, cls, need_receipts)
    inbox, inbox_valid, n_dropped, edge_slot, shed = kernels.deliver_ragged(
        dst, cols, valid, n_peers, inbox_size, shards, budget, cls,
        need_receipts)
    return RaggedDelivery(
        Delivery(tuple(inbox), inbox_valid, n_dropped, edge_slot), shed)

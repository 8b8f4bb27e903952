"""The delivery op: UDP datagrams as a sort-by-receiver scatter (port of
``dispersy_tpu/ops/inbox.py``).

Every logical packet of a round is an edge (destination, payload
columns).  Delivery groups edges by destination in edge order, gives each
its rank in the group, and scatters ranks < Q into bounded ``[N, Q]``
inboxes; the rest are dropped and counted per destination.  Invalid or
out-of-range destinations park (never delivered, never counted).

:func:`deliver` is a wrapper: a CPU tensor takes the plain version (a
sort on the packed (destination, position) key), a CUDA tensor the
hand-written stable counting sort in ``csrc/deliver.cu``.
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


def deliver_plain(dst, cols, valid, n_peers: int,
                  inbox_size: int) -> Delivery:
    e = dst.shape[0]
    dev = dst.device
    q = inbox_size
    ok = valid & (dst >= 0) & (dst < n_peers)
    key = torch.where(ok, dst.to(torch.int64), n_peers)
    pos = torch.arange(e, dtype=torch.int64, device=dev)
    spacked = torch.sort(key * max(e, 1) + pos).values
    skey = spacked // max(e, 1)
    spos = spacked % max(e, 1)
    is_start = torch.ones(e, dtype=torch.bool, device=dev)
    is_start[1:] = skey[1:] != skey[:-1]
    first = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    slot = pos - first
    keep = (skey < n_peers) & (slot < q)
    edge_slot = torch.empty(e, dtype=torch.int32, device=dev)
    edge_slot[spos] = torch.where(keep, slot, -1).to(torch.int32)
    kept = edge_slot >= 0
    flat = key[kept] * q + edge_slot[kept].to(torch.int64)
    inbox = []
    for c in cols:
        out = torch.zeros((n_peers * q,) + tuple(c.shape[1:]),
                          dtype=bits(c).dtype, device=dev)
        out[flat] = bits(c)[kept]
        inbox.append(unbits(out, c.dtype).reshape(
            (n_peers, q) + tuple(c.shape[1:])))
    inbox_valid = torch.zeros(n_peers * q, dtype=torch.bool, device=dev)
    inbox_valid[flat] = True
    n_dropped = torch.bincount(key[ok & ~kept], minlength=n_peers)[
        :n_peers].to(torch.int32)
    return Delivery(inbox=tuple(inbox),
                    inbox_valid=inbox_valid.reshape(n_peers, q),
                    n_dropped=n_dropped, edge_slot=edge_slot)


def deliver(dst: torch.Tensor, cols: Sequence[torch.Tensor],
            valid: torch.Tensor, n_peers: int,
            inbox_size: int) -> Delivery:
    """Deliver an edge list into per-peer inboxes.

    ``dst``: i32[E]; ``cols``: payload columns [E] or [E, W] (u32, u16, u8
    or bool); ``valid``: bool[E].  Order within a destination is edge order;
    ``edge_slot`` is each edge's receipt (its inbox slot, or -1).
    """
    if dst.device.type == "cpu":
        return deliver_plain(dst, cols, valid, n_peers, inbox_size)
    inbox, inbox_valid, n_dropped, edge_slot = kernels.deliver(
        dst, cols, valid, n_peers, inbox_size)
    return Delivery(tuple(inbox), inbox_valid, n_dropped, edge_slot)

"""Carry a ``PeerState`` across packages: the port's stand-in for weights.

A state is a flat ``{leaf path: numpy array}`` dict keyed by the JAX
package's leaf names (``"store_gt"``, ``"stats.walk_success"``, ...), so a
JAX state dumped to numpy becomes the port's state and back, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.state import PeerState, Stats, resolve_device


def leaf_names() -> list:
    """Every leaf path, in ``PeerState`` field order."""
    out = []
    for f in dataclasses.fields(PeerState):
        if f.name == "stats":
            out += [f"stats.{g.name}" for g in dataclasses.fields(Stats)]
        else:
            out.append(f.name)
    return out


def state_to_numpy(state) -> dict:
    """``{leaf path: numpy array}`` with every leaf's schema dtype (copies,
    never views of the state).
    ``state`` is a :class:`PeerState` or any state object with the same
    leaf names -- a JAX package state converts through ``np.asarray``."""
    out = {}
    for name in leaf_names():
        leaf = state
        for part in name.split("."):
            leaf = getattr(leaf, part)
        out[name] = (leaf.detach().to("cpu", copy=True).numpy()
                     if isinstance(leaf, torch.Tensor) else np.array(leaf))
    return out


def state_from_numpy(arrays: dict, cfg: CommunityConfig,
                     device="cuda") -> PeerState:
    """The inverse of :func:`state_to_numpy`.  Every leaf must be present;
    dtypes are kept as given (the schema dtypes)."""
    dev = resolve_device(device)
    missing = [k for k in leaf_names() if k not in arrays]
    if missing:
        raise KeyError(f"state arrays lack leaves {missing[:5]}")

    def t(name):
        return torch.from_numpy(np.array(arrays[name], order="C")).to(dev)

    stats = Stats(**{g.name: t(f"stats.{g.name}")
                     for g in dataclasses.fields(Stats)})
    kw = {f.name: t(f.name) for f in dataclasses.fields(PeerState)
          if f.name != "stats"}
    if cfg.n_peers != kw["alive"].shape[0]:
        raise ValueError(f"state holds {kw['alive'].shape[0]} peers, "
                         f"config says {cfg.n_peers}")
    return PeerState(stats=stats, **kw)


def first_difference(a: dict, b: dict) -> str | None:
    """Name and description of the first leaf where two numpy state dicts
    differ (dtype, shape or any value), or None when they are equal."""
    for name in leaf_names():
        x, y = a[name], b[name]
        if x.dtype != y.dtype or x.shape != y.shape:
            return (f"{name}: {x.dtype}{list(x.shape)} vs "
                    f"{y.dtype}{list(y.shape)}")
        if x.dtype.kind == "f":
            same = np.array_equal(x.view(np.uint32), y.view(np.uint32))
        else:
            same = np.array_equal(x, y)
        if not same:
            bad = np.argwhere(x != y)
            where = tuple(bad[0]) if bad.size else ()
            return (f"{name}: {int((x != y).sum())} element(s) differ, "
                    f"first at {where}: {x[where]!r} vs {y[where]!r}")
    return None


def assert_states_equal(a, b, context: str = "") -> None:
    """Raise ``AssertionError`` naming the first differing leaf.  ``a`` and
    ``b`` are states (either package's) or numpy state dicts."""
    da = a if isinstance(a, dict) else state_to_numpy(a)
    db = b if isinstance(b, dict) else state_to_numpy(b)
    diff = first_difference(da, db)
    if diff is not None:
        raise AssertionError(f"{context}{': ' if context else ''}{diff}")

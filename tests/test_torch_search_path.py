"""Every store row the engine makes stays on K5's search path: after each
schedule's creates and after every round, each row's raw (gt, member)
keys are non-decreasing over all M slots (EMPTY slots, gt = member =
0xFFFFFFFF, last), so ``intake_checks`` answers every row of a round by
binary search and never falls back to comparing every slot
(``csrc/intake.cu``).  The port alone, on the CPU, on the legacy,
permissioned and hardened schedules that ``test_torch_step.py`` and
``test_torch_hardened.py`` hold against the JAX package."""

import numpy as np
import pytest
import torch

from dispersy_tpu_torch import engine, init_state, profiling
from dispersy_tpu_torch.config import CommunityConfig

from test_torch_hardened import HARD_CASES, HARD_N, HARD_ROUNDS
from test_torch_ops import release_xla_executables  # noqa: F401
from test_torch_step import (CASES, PERM_CASES, PERM_N, PERM_ROUNDS,
                             ROUNDS)

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)


def legacy(kw, warm):
    """``test_torch_step.start``'s state and creates, the port alone."""
    pc = CommunityConfig(**kw)
    ps = init_state(pc, 5, device="cpu")
    if warm:
        ps = engine.seed_overlay(ps, pc, 6)
    n = kw["n_peers"]
    ps = engine.create_messages(
        ps, pc, torch.from_numpy(np.arange(n) % 16 == 3), 1,
        torch.from_numpy((np.arange(n) * 7 + 11).astype(np.int64)))
    return pc, ps, [], ROUNDS


def scheduled(pc, creates, rounds):
    return pc, engine.seed_overlay(init_state(pc, 5, device="cpu"), pc,
                                   6), creates, rounds


SCHEDULES = {f"legacy_{k}": (lambda k=k: legacy(*CASES[k])) for k in CASES}
SCHEDULES.update({k: (lambda k=k: scheduled(
    profiling.permissioned_config(PERM_N).replace(**PERM_CASES[k]),
    profiling.permissioned_schedule(PERM_N), PERM_ROUNDS))
    for k in PERM_CASES})
SCHEDULES.update({k: (lambda k=k: scheduled(
    profiling.hardened_config(HARD_N).replace(**HARD_CASES[k]),
    profiling.hardened_schedule(HARD_N), HARD_ROUNDS)) for k in HARD_CASES})


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_store_rows_stay_on_intake_search_path(schedule):
    pc, ps, creates, rounds = SCHEDULES[schedule]()
    for rnd in range(rounds):
        ps = profiling.run_creates(ps, pc, creates, rnd)
        assert profiling.intake_unsorted_rows(ps) == 0, f"round {rnd} creates"
        ps = engine.step(ps, pc)
        assert profiling.intake_unsorted_rows(ps) == 0, f"round {rnd}"
    # The stores filled: the rounds put the invariant to work.
    assert int((ps.store_gt.view(torch.int32) != -1).sum()) > pc.n_peers

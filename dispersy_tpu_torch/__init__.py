"""dispersy_tpu_torch: the PyTorch / CUDA port of ``dispersy_tpu``.

The ``engine.step`` round runs here for every ``CommunityConfig``: the
legacy ring and the byte-diet store, one community or several, with
every plane and protocol feature; ``checkpoint`` writes and reads the
JAX package's single-file archives and ``scenario`` runs its scripted
timelines (``python -m dispersy_tpu_torch.scenario FILE``).  Entry
points run on ``"cuda"`` unless the caller passes ``device="cpu"``; a CPU
tensor takes each hot op's plain PyTorch version, a CUDA tensor its
hand-written kernel (``kernels``, ``csrc``).  Nothing here imports JAX or
the JAX package.
"""

from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.engine import (coverage, coverage_by_community,
                                       create_messages,
                                       create_signature_request,
                                       load_members, multi_step,
                                       seed_overlay, step, unload_members)
from dispersy_tpu_torch.exceptions import (CheckpointError, ConfigError,
                                           KernelError)
from dispersy_tpu_torch.state import PeerState, init_state

__all__ = ["CheckpointError", "CommunityConfig", "ConfigError",
           "KernelError", "PeerState", "coverage", "coverage_by_community",
           "create_messages", "create_signature_request", "init_state",
           "load_members", "multi_step", "seed_overlay", "step",
           "unload_members"]

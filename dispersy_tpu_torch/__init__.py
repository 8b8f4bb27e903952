"""dispersy_tpu_torch: the PyTorch / CUDA port of ``dispersy_tpu``.

The ``engine.step`` round runs here on the legacy ring and the byte-diet
store, with the planes and protocol features ``engine.check_slice``
does not name as off the slice.  Entry points run on ``"cuda"`` unless
the caller passes ``device="cpu"``; a CPU tensor takes each hot op's
plain PyTorch version, a CUDA tensor its hand-written kernel
(``kernels``, ``csrc``).  Nothing here imports JAX or the JAX package.
"""

from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.engine import (coverage, create_messages,
                                       create_signature_request, multi_step,
                                       seed_overlay, step)
from dispersy_tpu_torch.exceptions import ConfigError, KernelError
from dispersy_tpu_torch.state import PeerState, init_state

__all__ = ["CommunityConfig", "ConfigError", "KernelError", "PeerState",
           "coverage", "create_messages", "create_signature_request",
           "init_state", "multi_step",
           "seed_overlay", "step"]

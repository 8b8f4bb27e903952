"""The round's ops (mirrors ``dispersy_tpu/ops``): plain PyTorch on a CPU
tensor, the hand-written kernels of :mod:`dispersy_tpu_torch.kernels` on a
CUDA tensor."""

"""Tensor ops: plain torch building blocks and the hand-written kernels."""

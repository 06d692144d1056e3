"""Attention ops (plain PyTorch versions and the Hopper kernels), the
loss registry and the optimizers."""

"""Attention ops (plain PyTorch versions and the Hopper kernels) and the
optimizers."""

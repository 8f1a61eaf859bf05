"""Image ops, the fused augmentation chain and the kernels under it."""

"""Hand-written Hopper kernels (sources in medseg_tpu_torch/csrc/) and their
wrappers.  A wrapper runs its kernel's plain PyTorch version for CPU tensors
and launches the kernel, or raises, for CUDA tensors."""

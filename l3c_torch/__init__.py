"""l3c_torch: the L3C lossless image codec in PyTorch for NVIDIA Hopper.

A port of `l3c_tpu` (the JAX package beside it, which stays the reference).
This package imports torch, numpy and the standard library only. Its entry
points run on CUDA unless the caller passes `device="cpu"`; there is no
silent CPU fallback. Hot loops of the coder are CUDA kernels written by
hand (`l3c_torch/ops/kernels/csrc`), each with a plain PyTorch version
beside it that CPU tensors take.
"""

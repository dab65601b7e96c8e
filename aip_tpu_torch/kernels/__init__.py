"""Hand-written Hopper kernels and their Python wrappers.

Each wrapper launches its CUDA kernel for a CUDA tensor (or raises), and
runs the plain PyTorch version beside it only for a CPU tensor. Nothing
here builds or loads a kernel at import time: the CUDA sources under
``aip_tpu_torch/csrc`` are compiled with nvcc at first use.
"""

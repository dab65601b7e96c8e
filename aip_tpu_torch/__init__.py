"""PyTorch / CUDA port of ``aip_tpu`` for NVIDIA Hopper (H100).

The JAX package ``aip_tpu`` is the reference; this package mirrors its
module layout (``ops``, ``models``, ``pipelines``, ``cli``) and adds
``kernels`` (Python wrappers) and ``csrc`` (hand-written CUDA C++ built
with nvcc for ``sm_90a`` at first use).

Conventions shared with the reference:

* public tensors are NHWC ``[N, H, W, C]`` (inside, convolutions run on
  ``permute(0, 3, 1, 2)`` views, which carry channels_last strides);
* conv parameters are ``nn.Module``s (``VGGEncoder``, ``AdaINDecoder``)
  whose weights are the reference's HWIO arrays transposed to OIHW;
* statistics are taken in float32 whatever the compute dtype.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise rather than run on the CPU. Tests pass ``device="cpu"``.
"""

"""Tensor ops of the AdaIN path (ports of ``aip_tpu.ops``)."""

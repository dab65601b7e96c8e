"""Tensor ops (ports of ``aip_tpu.ops``): image resizing and padding, AdaIN,
depth, colour transfer, flows, metrics and the 3DGS maths."""

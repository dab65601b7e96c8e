"""Models of the AdaIN path (ports of ``aip_tpu.models``)."""

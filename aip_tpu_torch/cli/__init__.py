"""Command-line entry points (ports of ``aip_tpu.cli``)."""

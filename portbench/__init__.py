"""The benchmark of ``aip_tpu_torch`` on one H100: see README.md."""

"""General utilities (port of ``aip_tpu.utils``; reference
``Style_3DGS/utils/{general,system}_utils.py``)."""

from aip_tpu_torch.utils.system import mkdir_p, safe_state, search_for_max_iteration

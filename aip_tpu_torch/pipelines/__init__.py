"""Pipelines (ports of ``aip_tpu.pipelines``)."""

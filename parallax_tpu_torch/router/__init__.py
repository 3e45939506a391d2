"""Standalone HTTP load balancer over several serving clusters (port of
``parallax_tpu/router``)."""

"""Shared utilities: tracing and throughput meters (``utils.profiling``)."""

"""Shared utilities: tracing and throughput meters (``utils.profiling``), and a
reader of the JAX package's flax msgpack checkpoints (``utils.flax_msgpack``)."""

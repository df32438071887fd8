"""Shared utilities: tracing (``utils.profiling``: a profiler trace, the
port's ``port.`` spans), and a reader of the JAX package's flax msgpack
checkpoints (``utils.flax_msgpack``)."""

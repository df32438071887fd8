"""Train and eval steps (``steps``) and data parallelism across processes,
one a device (``distributed``, ``mesh``)."""

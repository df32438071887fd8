"""Train and eval steps.  One GPU in this slice; data parallelism over
several GPUs is a later slice (ROADMAP.md)."""

"""Train and eval steps (pretraining and fine-tuning).  One GPU so far;
data parallelism over several GPUs is a later slice (ROADMAP.md)."""

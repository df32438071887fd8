"""Command-line entry points (``python -m ssl_cr_histo_tpu_torch.cli.pretrain``)."""

"""Convert a checkpoint directory of the JAX package to the reference's torch
format: the port's copy of ``ssl_cr_histo_tpu/cli/convert_checkpoint.py``,
which needs no JAX and no flax, so it runs on the GPU machine.

    python -m ssl_cr_histo_tpu_torch.cli.convert_checkpoint \\
        --input runs/best --output model.pt

Reads ``checkpoint.msgpack`` and ``meta.json`` (``train.checkpoint.
read_jax_checkpoint``) and writes with ``torch.save`` what the JAX CLI
writes (``train.checkpoint.jax_to_reference``): ``model``, the torchvision-
named TripletNet state_dict with BN ``num_batches_tracked`` 0, ``classifier``
where the checkpoint has a head, and the meta's ``epoch``.  The result is a
``.pth`` the port's CLIs, and the reference's modules, load strictly.  The
stage CLIs also take the directory itself (``--model_path``,
``--finetune_ckpt``).  Host only: no device is touched.
"""

from __future__ import annotations

import argparse

import torch

from ssl_cr_histo_tpu_torch.train.checkpoint import jax_to_reference, read_jax_checkpoint


def main(argv=None) -> dict:
    """Returns the dict saved."""
    p = argparse.ArgumentParser("native checkpoint -> reference torch format")
    p.add_argument("--input", required=True, help="native checkpoint directory (checkpoint.msgpack + meta.json)")
    p.add_argument("--output", required=True, help="output .pt path")
    args = p.parse_args(argv)

    out = jax_to_reference(*read_jax_checkpoint(args.input))
    torch.save(out, args.output)
    n = len(out["model"]) + len(out.get("classifier", {}))
    print(f"{args.input} -> {args.output} ({n} tensors, epoch {out['epoch']})")
    return out


if __name__ == "__main__":
    main()

"""Camelyon16 WSI tumour-probability maps on a GPU (reference
test_Camelyon16.py): the counterpart of ``ssl_cr_histo_tpu/cli/heatmap.py``.

Pairs each WSI with its tissue mask by basename, runs the resnet eval-mode
forward over ``--image_size`` patches centred on each tissue cell, batch
``--batch_size`` (256), bf16 unless ``--no-bf16``, and writes per slide
what the JAX CLI writes (``eval.heatmap.save_heatmap_artifacts``):
``{id}.npy``, ``{id}.png``, ``{id}_heatmap.png``, and
``{id}_heatmap_bar.png`` where matplotlib is installed.

    python -m ssl_cr_histo_tpu_torch.cli.heatmap --test_image_pth WSIS/ --test_mask_pth MASKS/ \\
        --probs_map_path MAPS/ --finetune_ckpt CR_RUN/best.pth

``--finetune_ckpt`` is a fine-tune or consistency ``.pth`` of the port or
the reference (``'model'`` and ``'classifier'``), whose 2-way head is
loaded (the reference leaves it random, test_Camelyon16.py:126-127).
``--reference_exact`` turns bf16 off; ``--remat`` and ``--aug_mode`` are
accepted as the JAX CLI accepts them: an eval forward keeps no activations
for a backward pass and augments nothing.

On N cards: ``python3 -m torch.distributed.run --nproc_per_node N -m
ssl_cr_histo_tpu_torch.cli.heatmap ...``; each process forwards its rows of
every batch, every process holds the whole map, and the primary writes the
artifacts (the JAX CLI's sharded patch grid, ``cli/heatmap.py:68-115``).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ssl_cr_histo_tpu_torch.cli.common import add_common_args, apply_reference_exact, resolve_device, seed_everything
from ssl_cr_histo_tpu_torch.data.wsi import open_slide
from ssl_cr_histo_tpu_torch.eval.heatmap import compute_probs_map, pair_wsi_masks, save_heatmap_artifacts
from ssl_cr_histo_tpu_torch.parallel.distributed import is_primary
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.train.init import init_serving_state


def parse_args(argv=None):
    p = argparse.ArgumentParser("Camelyon16 WSI heatmap inference (PyTorch / CUDA)")
    p.add_argument("--test_image_pth", required=True, help="dir of WSIs (.tif/.svs/.npy)")
    p.add_argument("--test_mask_pth", required=True, help="dir of tissue masks (.npy)")
    p.add_argument("--probs_map_path", required=True, help="output dir")
    p.add_argument("--finetune_ckpt", required=True,
                   help="fine-tune or consistency checkpoint (.pth with 'model' and a 2-way 'classifier')")
    p.add_argument("--batch_size", type=int, default=256, help="patches per forward")
    add_common_args(p)  # --image_size 0 = 256 here
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {wsi_id: probability map} of the slides written."""
    args = apply_reference_exact(parse_args(argv), "heatmap")
    device = resolve_device(args)
    seed_everything(args.seed, device)
    image_size = args.image_size or 256
    state = init_serving_state(args.model, 2, device, args.finetune_ckpt)
    forward = lambda patches: S.forward(state, patches, bf16=args.bf16)  # noqa: E731

    wsipaths = []
    for ext in ("tif", "svs", "npy"):
        wsipaths += glob.glob(os.path.join(args.test_image_pth, f"*.{ext}"))
    maskpaths = glob.glob(os.path.join(args.test_mask_pth, "*.npy"))
    try:
        pairs = pair_wsi_masks(wsipaths, maskpaths)
    except ValueError as e:
        raise SystemExit(str(e))

    maps = {}
    for wsi_pth, mask_pth in pairs:
        wsi_id = os.path.splitext(os.path.basename(wsi_pth))[0]
        reader = open_slide(wsi_pth)
        mask = np.load(mask_pth)
        n = int(np.count_nonzero(mask))
        print(f"==> {wsi_id}: {n} tissue positions")
        t0 = time.time()
        maps[wsi_id] = compute_probs_map(reader, mask, forward, device, image_size=image_size,
                                         batch_size=args.batch_size)
        secs = time.time() - t0
        if not is_primary():  # every process holds the whole map
            continue
        bar = save_heatmap_artifacts(maps[wsi_id], args.probs_map_path, wsi_id)
        print(f"==> {wsi_id}: {n} patches in {secs:.2f} s ({n / max(secs, 1e-9):.1f} patches/s); wrote "
              f"{args.probs_map_path}/{wsi_id}*" + ("" if bar else " (no colour-bar figure: matplotlib is not "
                                                                 "installed)"))
    return maps


if __name__ == "__main__":
    main()

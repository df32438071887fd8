"""RSP self-supervised pretraining on a GPU.

Counterpart of ``ssl_cr_histo_tpu/cli/pretrain.py:124-363``, both
variants.  Config of record (reference pretrain_BreastPathQ.py:151-196,
:245-247): ResNet18, batch 64 triplets of 256x256 tiles, fused v1
augmentation with the photometric kernel, joint encode, bf16 autocast,
SGD-Nesterov lr 0.01 wd 1e-4, Lookahead(5, 0.5) stepped per epoch.
``--variant v2`` is the paper's v2 script (Pretraining_v2/pretrain_RSP.py,
``--tile_stride 768``): the v2 sampler geometry and RandAugment(``--NAug``,
``--Magn``) per tile, in PyTorch ops (``--aug_mode`` fused, masked or
exact).  v1's ``--aug_mode exact`` runs the pool op by op; fast and masked
are the fused kernel, as in the JAX package.  ``--reference_exact``
applies the strict-parity preset (float32, per-view BN, exact
augmentation, the x6 orderings); ``--remat`` recomputes the backbone's
blocks in the backward pass.

    python -m ssl_cr_histo_tpu_torch.cli.pretrain --train_image_pth SLIDES/ --save_dir RUN/

Writes ``train_results.csv``, ``best.pth`` and ``ckpt_<epoch>.pth`` (the
reference's torch checkpoint layout, see ``train.checkpoint``) under
``--save_dir``.  ``--resume ckpt_<N>.pth|auto`` continues a run from its
checkpoint; ``--expand_orderings`` takes the reference's strict epoch (every
triplet under each of the 6 orderings), ``--cache_tiles`` keeps every read
triplet in host memory across epochs, and ``--tsne`` writes the best epoch's
train features with their t-SNE plot and, at the end, ``tsne.png`` of the
validation features under all 6 orderings.

On N cards: ``python3 -m torch.distributed.run --nproc_per_node N -m
ssl_cr_histo_tpu_torch.cli.pretrain ...``; every process reads the same
batches and trains on its ``--batch_size / N`` triplets of each
(``parallel.distributed``), and the primary writes.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.cli.common import (
    add_common_args,
    apply_reference_exact,
    resolve_device,
    resume_training,
    seed_everything,
)
from ssl_cr_histo_tpu_torch.data import ReaderCache, RSPTripletSampler, TripletIndex
from ssl_cr_histo_tpu_torch.data.pipeline import pad_batches, prefetch_to_device
from ssl_cr_histo_tpu_torch.parallel import distributed as D
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_triplet_state
from ssl_cr_histo_tpu_torch.train.loop import BestTracker, CsvLogger, lookahead_epoch


def parse_args(argv=None):
    p = argparse.ArgumentParser("RSP pretraining (PyTorch / CUDA)")
    p.add_argument("--train_image_pth", required=True, help="directory of WSIs (.tif/.svs/.npy)")
    p.add_argument("--variant", default="v1", choices=["v1", "v2"],
                   help="v1 (pretrain_BreastPathQ/Camelyon16) or v2 (Pretraining_v2/pretrain_RSP.py)")
    p.add_argument("--tile_h", type=int, default=256)
    p.add_argument("--tile_w", type=int, default=256)
    p.add_argument("--tile_stride", type=int, default=128,
                   help="128 BreastPathQ / 512 Camelyon16 (BASELINE.md)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_epoch", type=int, default=250)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--la_steps", type=int, default=5)
    p.add_argument("--la_alpha", type=float, default=0.5)
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--best_gate_epoch", type=int, default=0,
                   help="only save best-val after this epoch (80 for Camelyon16)")
    p.add_argument("--validation_size", type=int, default=3000,
                   help="triplets held out for validation (3000 BPQ / 10000 Cam16)")
    p.add_argument("--validation_fraction", type=float, default=0.0,
                   help=">0 holds out a seeded fraction instead of a fixed count")
    p.add_argument("--lwst_level_idx", type=int, default=1,
                   help="thumbnail level for foreground stats, counted from the bottom "
                        "of the pyramid (1 BreastPathQ / 5 Camelyon16)")
    p.add_argument("--no_augment", action="store_true", help="train on raw tiles (ablation)")
    p.add_argument("--NAug", type=int, default=2, help="v2 RandAugment n")
    p.add_argument("--Magn", type=float, default=3.0, help="v2 RandAugment m")
    p.add_argument("--expand_orderings", action="store_true",
                   help="strict reference epochs: every triplet once under each of the 6 orderings, "
                        "shuffled (6x the steps of an epoch)")
    p.add_argument("--cache_tiles", action="store_true",
                   help="keep every read triplet in host RAM across epochs (the reference's all-in-RAM "
                        "dataset; ~590 KB a 256^2 position)")
    p.add_argument("--read_workers", type=int, default=0, help="triplet-read threads per batch")
    p.add_argument("--index_cache_dir", default="auto",
                   help="persistent slide-index cache ('auto' = <train_image_pth>/.rsp_index; "
                        "'' disables)")
    p.add_argument("--index_workers", type=int, default=0)
    p.add_argument("--resume", default="",
                   help="a ckpt_<N>.pth to resume from, or 'auto' for the latest under --save_dir")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="0 = full pass over the sampled index")
    p.add_argument("--joint_encode", action="store_true", default=True,
                   help="one backbone pass over the 3 views (BN statistics pooled "
                        "across them); on by default")
    p.add_argument("--no_joint_encode", dest="joint_encode", action="store_false")
    p.add_argument("--tsne", action="store_true",
                   help="at each new best, save the epoch's train features and their t-SNE plot; at the "
                        "end, tsne.png of the validation features under all 6 orderings")
    add_common_args(p)
    return p.parse_args(argv)


def split_validation(indices, args):
    """Hold out whole triplet positions for validation, seeded
    (``cli/pretrain.py:157-179``)."""
    rng = np.random.default_rng(args.seed)
    flat = [(i, j) for i, idx in enumerate(indices) for j in range(len(idx.coords))]
    order = rng.permutation(len(flat))
    if args.validation_fraction > 0:
        n_val = int(len(flat) * args.validation_fraction)
    else:
        n_val = min(args.validation_size, len(flat) // 5)
    if n_val == 0:
        print("WARNING: validation holdout is empty (too few triplet positions); "
              "val metrics will read 0.0")
    val_set = set(order[:n_val].tolist())
    flat_pos = {t: k for k, t in enumerate(flat)}
    train, val = [], []
    for slide_i, idx in enumerate(indices):
        rows = np.array([flat_pos[(slide_i, j)] in val_set for j in range(len(idx.coords))], bool)
        train.append(TripletIndex(idx.slide_path, idx.coords[~rows]))
        if rows.any():
            val.append(TripletIndex(idx.slide_path, idx.coords[rows]))
    return train, val


def save_best_features(save_dir: str, epoch: int, feats: list, targets: list) -> None:
    """The reference's best-epoch artifacts (pretrain_BreastPathQ.py:322-340,
    ``cli/pretrain.py:319-333``): the train epoch's features and orderings
    as ``best_pre_trained_{feats,targets}_<epoch>.npy`` and their t-SNE plot
    ``best_tsne_feats_<epoch>.png``."""
    from ssl_cr_histo_tpu_torch.eval.reporting import save_tsne_plot

    if not D.is_primary():
        return
    f, t = np.concatenate(feats), np.concatenate(targets)
    np.save(os.path.join(save_dir, f"best_pre_trained_feats_{epoch}.npy"), f)
    np.save(os.path.join(save_dir, f"best_pre_trained_targets_{epoch}.npy"), t)
    save_tsne_plot(f, t, os.path.join(save_dir, f"best_tsne_feats_{epoch}.png"))


def save_val_tsne(args, state, sampler, val_positions, readers, tile_cache, device) -> None:
    """``tsne.png`` of every validation triplet's features under each of the
    6 orderings, labelled by ordering (``cli/pretrain.py:339-361``),
    gathered from every process and drawn by the primary."""
    from ssl_cr_histo_tpu_torch.eval.reporting import save_tsne_plot

    feats, targets = [], []
    vb = sampler.iter_batches(val_positions, args.batch_size, seed=0, drop_last=False, readers=readers,
                              tile_cache=tile_cache, read_workers=args.read_workers)
    for tiles, valid in prefetch_to_device(pad_batches(vb, args.batch_size, D.process_count()), device):
        f = S.pretrain_eval_step(state, tiles, valid, bf16=args.bf16, return_feats=True)["feats"]
        keep = D.fetch_global(valid).bool()
        for label in range(6):
            feats.append(f[label][keep].float().cpu().numpy())
            targets.append(np.full(int(keep.sum()), label, np.int32))
    if not D.is_primary():
        return
    save_tsne_plot(np.concatenate(feats), np.concatenate(targets), os.path.join(args.save_dir, "tsne.png"))
    print("==> saved t-SNE plot")


def main(argv=None):
    args = apply_reference_exact(parse_args(argv), "pretrain")
    if args.image_size:
        args.tile_h = args.tile_w = args.image_size
    if args.tile_h != args.tile_w:
        raise SystemExit("non-square tiles are not supported (tile_h != tile_w)")
    device = resolve_device(args)
    rows_for_batch(args.batch_size)  # an indivisible batch fails before the slides are indexed
    gen = seed_everything(args.seed, device)
    # the tables of the PyTorch-op policies (v2, v1 exact) are drawn on the
    # host, their groups formed there (``ops.randaugment.stage_groups``)
    host_gen = torch.Generator().manual_seed(args.seed + 1)

    sampler = RSPTripletSampler(tile=args.tile_h, stride=args.tile_stride, geometry=args.variant,
                                lwst_level_idx=args.lwst_level_idx)
    print(f"==> indexing WSIs under {args.train_image_pth} ...")
    indices = sampler.index_directory(args.train_image_pth, cache_dir=args.index_cache_dir or None,
                                      n_workers=args.index_workers)
    n_total = sum(len(i.coords) for i in indices)
    if n_total == 0:
        raise SystemExit("no foreground tiles found")
    print(f"==> {n_total} triplet positions across {len(indices)} slides")
    train_indices, val_positions = split_validation(indices, args)

    state = init_triplet_state(args.model, device, lr=args.lr, weight_decay=args.weight_decay, remat=args.remat)
    step_kwargs = dict(augment=None if args.no_augment else args.variant, n_aug=args.NAug, m_aug=args.Magn,
                       aug_mode=args.aug_mode, host_gen=host_gen, joint_encode=args.joint_encode, bf16=args.bf16,
                       return_feats=args.tsne)

    os.makedirs(args.save_dir, exist_ok=True)
    log = CsvLogger(os.path.join(args.save_dir, "train_results.csv"),
                    "epoch, train_loss, train_acc, val_loss, val_acc")
    gens = {"gen": gen, "host_gen": host_gen}
    best = BestTracker(args.save_dir, mode="min", gate_epoch=args.best_gate_epoch, generators=gens)
    # restores the state, Lookahead's slow weights, the best value (so a
    # resumed epoch that is not better cannot overwrite best.pth) and the
    # ordering and augmentation generators (``cli/pretrain.py:209-213``)
    start_epoch, _ = resume_training(args, state, best, gens)

    readers = ReaderCache(capacity=64)
    tile_cache = {} if args.cache_tiles else None
    for epoch in range(start_epoch, args.num_epoch + 1):
        t0 = time.time()
        # sums stay on the device; reading them synchronises, so only the
        # progress prints and the epoch's end do
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        seen = 0
        epoch_feats, epoch_targets = [], []
        batches = sampler.iter_batches(train_indices, args.batch_size, seed=args.seed + epoch,
                                       readers=readers, expand_orderings=args.expand_orderings,
                                       tile_cache=tile_cache, read_workers=args.read_workers)
        if not args.expand_orderings:
            batches = ((t,) for t in batches)
        if args.steps_per_epoch:
            batches = itertools.islice(batches, args.steps_per_epoch)
        # a thread reads and pins the next batches while the card runs this
        # one (``cli/pretrain.py:302-304``); the order and seeds are the
        # sampler's, and under --expand_orderings its labels ride along
        for bi, (tiles, *labels) in enumerate(prefetch_to_device(batches, device)):
            m = S.pretrain_step(state, tiles, gen, labels=labels[0] if labels else None,
                                global_batch=args.batch_size, **step_kwargs)
            n = args.batch_size
            loss_sum += m["loss"] * n
            acc_sum += m["acc"] * n
            seen += n
            if args.tsne:
                # the reference keeps every train batch's features for the
                # best-epoch dump (pretrain_BreastPathQ.py:71-89)
                epoch_feats.append(m["feats"].float().cpu().numpy())
                epoch_targets.append(m["labels"].cpu().numpy().astype(np.int32))
            if (bi + 1) % args.print_freq == 0:
                print(f"Train: [{epoch}][{bi + 1}] loss {float(m['loss']):.3f} "
                      f"({float(loss_sum) / seen:.3f}) acc {float(acc_sum) / seen:.3f}")
        train_loss = float(loss_sum) / max(seen, 1)
        train_acc = float(acc_sum) / max(seen, 1)
        print(f"Epoch time: {time.time() - t0:.2f} s.")

        # validation: every held-out triplet under all 6 orderings; the last
        # partial batch is zero-padded with a validity mask; both come through
        # the prefetch thread (``cli/pretrain.py:274``)
        sums = {k: torch.zeros((), device=device) for k in ("loss_sum", "correct", "count")}
        vb = sampler.iter_batches(val_positions, args.batch_size, seed=0, drop_last=False,
                                  readers=readers, tile_cache=tile_cache, read_workers=args.read_workers)
        for tiles, valid in prefetch_to_device(pad_batches(vb, args.batch_size, D.process_count()), device):
            out = S.pretrain_eval_step(state, tiles, valid, bf16=args.bf16)
            for k in sums:
                sums[k] += out[k]
        count = float(sums["count"])
        val_loss = float(sums["loss_sum"]) / count if count else 0.0
        val_acc = float(sums["correct"]) / count if count else 0.0

        log.append(epoch, train_loss, train_acc, val_loss, val_acc)
        state = lookahead_epoch(state, args.la_steps, args.la_alpha)
        meta = {"epoch": epoch, "args": vars(args), "train_loss": train_loss, "val_loss": val_loss}
        if best.update(val_loss, epoch, state, meta):
            print(f"==> new best val loss {val_loss:.4f}")
            if args.tsne and epoch_feats:
                save_best_features(args.save_dir, epoch, epoch_feats, epoch_targets)
        if args.save_freq and epoch % args.save_freq == 0:
            meta["best_val"] = best.best_value
            save_checkpoint(os.path.join(args.save_dir, f"ckpt_{epoch}.pth"), state, meta, gens)
    if args.tsne and val_positions:
        save_val_tsne(args, state, sampler, val_positions, readers, tile_cache, device)
    readers.close()
    print("done.")


if __name__ == "__main__":
    main()

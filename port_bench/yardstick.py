"""The benchmark's yardstick: the card's published peaks, the work a step
needs counted from its shapes, and the least time of the fused
augmentation kernel.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores,
3.35 TB/s of HBM.

Model work counts the multiply-adds of every matrix product from the
shapes alone, two operations each: the backbone family's own count
(``backbone_macs`` of ``port_bench.reference.<family>``: convolutions and
linears, and an attention family's QK^T and PV), and the heads' linears.
A trained pass counts its forward, its gradient with respect to the
weights and its gradient with respect to the input (three times the
forward), except the input gradient of the first layer on the image, which
no step computes; a forward without gradient (the consistency teacher)
counts once.  Norms, pooling, softmax, element-wise work, augmentation and
recomputation are not counted.

The fused kernel's operations per pixel are the count ``chip_smoke.py``
makes of ``csrc/rsp_augment.cu`` (its ``PIXEL_OPS``), frozen here: a later
change to the kernel does not change what it is measured against.  The
gated stages are counted at the v1 pool's gate probability (0.5 each),
since the draws of a timed step are made inside it.
"""

from __future__ import annotations

from port_bench.reference.nets import family

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

PIXEL_OPS = {
    "warp": 70,       # 2 folded positions with their taps' hat weights (26 each), 18 mul/add
    "blur": 18,       # 2 sliding passes, 3 channels
    "hsv": 45,        # rgb2hsv, the three shifts, hsv2rgb
    "philox": 126,    # 10 rounds (4 + 4 xor + 2 key adds), 4 uniforms, Box-Muller
    "noise": 12,      # x + n * sigma, clipped, 3 channels
    "hed": 60,        # 3 log, 2 3x3 products, the shift, 3 exp, (e - 1) / 2, clip
    "bc": 15,         # x * (1 + c) + b, clipped, 3 channels
    "normalize": 12,  # clip, (x - mean) / std, 3 channels
}
GATE_P = 0.5
N_PARAMS = 16


def backbone_macs(cfg: dict, size: int) -> tuple:
    """(multiply-adds of one image's backbone forward at ``size``^2, those
    of its first layer on the image): the family's count."""
    return family(cfg).backbone_macs(cfg, size)


def pair_macs(cfg: dict) -> int:
    """Multiply-adds of the pair head on one pair of embeddings."""
    d_in, d_hidden, d_out = cfg["pair_fc"]
    return d_in * d_hidden + d_hidden * d_out


def trained_flops(fwd_macs: int, first_conv_macs: int) -> float:
    return 2.0 * (3 * fwd_macs - first_conv_macs)


def pretrain_step_flops(cfg: dict, batch: int, size: int, classes: int = 6) -> float:
    """One RSP pretraining step: B*3 views through the backbone, three
    pairs a triplet through the pair head, the classifier; all trained."""
    macs, first = backbone_macs(cfg, size)
    feat = 3 * cfg["pair_fc"][2]
    head = 3 * pair_macs(cfg) + feat * cfg["rsp_hidden"] + cfg["rsp_hidden"] * classes
    return batch * 3 * trained_flops(macs, first) + batch * trained_flops(head, 0)


def single_flops(cfg: dict, size: int, classes: int) -> tuple:
    """(backbone, head) forward multiply-adds of one image's
    ``encode_single`` pass and the fine-tune head, with the first layer's."""
    macs, first = backbone_macs(cfg, size)
    return macs, first, pair_macs(cfg) + 3 * cfg["pair_fc"][2] * classes


def finetune_step_flops(cfg: dict, views: int, size: int, classes: int) -> float:
    """A fine-tune step: ``views`` images through ``encode_single`` and the
    head, all trained."""
    macs, first, head = single_flops(cfg, size, classes)
    return views * trained_flops(macs + head, first)


def consistency_step_flops(cfg: dict, student: int, teacher: int, size: int, classes: int) -> float:
    """A consistency step: ``teacher`` weak views forward only, ``student``
    views (labeled and strong) trained."""
    macs, first, head = single_flops(cfg, size, classes)
    return student * trained_flops(macs + head, first) + teacher * 2.0 * (macs + head)


def rsp_augment_least_s(batch: int, size: int) -> float:
    """The least time of one launch of the fused kernel on ``batch``
    triplets of ``size``^2 (uint8 in, bf16 out, Philox noise): the larger of
    its operations over the float32 peak and its bytes over the HBM peak."""
    tiles, pixels = 3 * batch, size * size
    per_pixel = (PIXEL_OPS["warp"] + PIXEL_OPS["normalize"] + PIXEL_OPS["hed"]
                 + GATE_P * (PIXEL_OPS["hsv"] + PIXEL_OPS["noise"] + PIXEL_OPS["philox"]
                             + PIXEL_OPS["blur"] + PIXEL_OPS["bc"]))
    ops = per_pixel * tiles * pixels
    n_bytes = tiles * pixels * 3 + tiles * 3 * pixels * 2 + tiles * (N_PARAMS + 9 + 1) * 4
    return max(ops / FP32_FLOPS, n_bytes / HBM_BYTES_PER_S)

"""The ViT's attention kernels' share of their roofline, in %: the least
time of one block's attention forward and backward at the mix's shapes (the
ViT family's ``attention_flops``, 14 V H T^2 d, over the bf16 peak) over
the device time of the flash backend's kernels in the traced stretch
(forward and backward, each record with its own time) per forward launch.
None where the stretch shows no flash forward launch."""

from port_bench import yardstick
from port_bench.readers import traced
from port_bench.reference import vit


def read(ctx):
    seconds = traced(ctx, "finetune", "kernel_s")
    if not seconds or ctx["cfg"].get("family") != "vit":
        return None
    counts = ctx["trace"]["kernel_count"]
    names = [n for n in seconds if "flash_fwd" in n or "flash_bwd" in n]
    # a split-KV forward's combine kernel is no launch of its own
    forward = sum(counts[n] for n in names if "flash_fwd" in n and "combine" not in n)
    if not forward:
        return None
    per_block = sum(seconds[n] for n in names) / forward
    fwd, bwd = vit.attention_flops(ctx["cfg"], 3 * ctx["traffic"]["batch"])
    return 100.0 * (fwd + bwd) / yardstick.BF16_FLOPS / per_block

"""The ViT family (``"family": "vit"``): UNI2-h's ViT-giant backbone from a
configuration file's numbers.

Chen et al. 2024 (UNI, Nature Medicine), the UNI2-h model card's timm
arguments (``vit_giant_patch14_224``): a ``patch_size`` x ``patch_size``
stride-``patch_size`` patch embedding with bias; position embeddings added to
the patch tokens only (``no_embed_class``), then the class token and
``reg_tokens`` register tokens put before them; ``depth`` pre-LN blocks
``x + ls1 * attn(norm1(x))``, ``x + ls2 * mlp(norm2(x))``; attention of
``num_heads`` heads with a biased ``qkv``, softmax(Q K^T / sqrt(d)) V
written out; the MLP SwiGLUPacked: ``fc1`` to ``int(embed_dim * mlp_ratio)``
split into halves a, b, then ``fc2(silu(a) * b)``; LayerNorm eps
``ln_eps``; the class token's final LayerNorm is the feature.  Parameter
names are timm's, under ``net.model.``.

Each block is recomputed in the backward pass (``torch.utils.checkpoint``,
without re-entry) where gradients are taken: plain attention keeps the
(N, heads, T, T) scores, and a fine-tune step at the cell's 96 views would
otherwise hold over 100 GB.  A block draws nothing and keeps no state, so
the recomputation gives the same numbers.

The family contract is in ``port_bench.reference.nets``; ``attention_flops``
is the count the ``attention_roofline`` reader divides by.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# the architecture the code below implements; a configuration that states
# another is refused
FIXED = {"class_token": True, "no_embed_class": True, "qkv_bias": True, "mlp_layer": "SwiGLUPacked",
         "act_layer": "SiLU", "gate_last": False, "global_pool": "token"}


def _check(cfg: dict):
    wrong = {k: cfg.get(k) for k, v in FIXED.items() if cfg.get(k) != v}
    derived = {"mlp_hidden": hidden(cfg), "head_dim": cfg["embed_dim"] // cfg["num_heads"]}
    wrong.update({k: cfg[k] for k, v in derived.items() if k in cfg and cfg[k] != v})
    if wrong:
        raise ValueError(f"configuration {cfg.get('name')!r}: the ViT family implements {FIXED}; got {wrong}")


def hidden(cfg: dict) -> int:
    """``fc1``'s width, timm's rounding of ``embed_dim * mlp_ratio``."""
    return int(cfg["embed_dim"] * cfg["mlp_ratio"])


def patches(cfg: dict) -> int:
    return (cfg["img_size"] // cfg["patch_size"]) ** 2


def tokens(cfg: dict) -> int:
    """Tokens a view: the patches, the class token and the registers."""
    return patches(cfg) + 1 + cfg["reg_tokens"]


def embed_dim(cfg: dict) -> int:
    return cfg["embed_dim"]


def backbone_spec(cfg: dict) -> list:
    """In timm's parameter order: kinds 'conv' (the patch embedding),
    'linear', 'bias' (0; LayerNorm shifts too), 'normal' (the class,
    register and position tokens, std ``token_std``) and 'fill' (LayerNorm
    scales 1, LayerScale ``layer_scale_fill``)."""
    _check(cfg)
    d, m = cfg["embed_dim"], "net.model."
    spec = [(f"{m}cls_token", (1, 1, d), "normal", cfg["token_std"]),
            (f"{m}reg_token", (1, cfg["reg_tokens"], d), "normal", cfg["token_std"]),
            (f"{m}pos_embed", (1, patches(cfg), d), "normal", cfg["token_std"]),
            (f"{m}patch_embed.proj.weight", (d, 3, cfg["patch_size"], cfg["patch_size"]), "conv"),
            (f"{m}patch_embed.proj.bias", (d,), "bias")]

    def norm(name):
        spec.extend([(f"{m}{name}.weight", (d,), "fill", 1.0), (f"{m}{name}.bias", (d,), "bias")])

    def linear(name, dout, din):
        spec.extend([(f"{m}{name}.weight", (dout, din), "linear"), (f"{m}{name}.bias", (dout,), "bias")])

    h = hidden(cfg)
    for i in range(cfg["depth"]):
        pre = f"blocks.{i}."
        norm(f"{pre}norm1")
        linear(f"{pre}attn.qkv", 3 * d, d)
        linear(f"{pre}attn.proj", d, d)
        spec.append((f"{m}{pre}ls1.gamma", (d,), "fill", cfg["layer_scale_fill"]))
        norm(f"{pre}norm2")
        linear(f"{pre}mlp.fc1", h, d)
        linear(f"{pre}mlp.fc2", d, h // 2)
        spec.append((f"{m}{pre}ls2.gamma", (d,), "fill", cfg["layer_scale_fill"]))
    norm("norm")
    return spec


def _block(cfg, p, pre, q, x):
    d, heads = cfg["embed_dim"], cfg["num_heads"]
    hd = d // heads
    g = lambda name: p[f"net.model.{pre}{name}"]
    lin = lambda name, t: q(F.linear(q(t), q(g(f"{name}.weight")), g(f"{name}.bias")))
    ln = lambda name, t: q(F.layer_norm(t, (d,), g(f"{name}.weight"), g(f"{name}.bias"), eps=cfg["ln_eps"]))
    n, t, _ = x.shape
    qkv = lin("attn.qkv", ln("norm1", x)).reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = q(q(qkv[0]) @ q(qkv[1]).transpose(-1, -2)) / math.sqrt(hd)
    a = q(q(torch.softmax(s, dim=-1)) @ q(qkv[2])).transpose(1, 2).reshape(n, t, d)
    x = q(x + g("ls1.gamma") * lin("attn.proj", a))
    u, v = lin("mlp.fc1", ln("norm2", x)).chunk(2, dim=-1)
    return q(x + g("ls2.gamma") * lin("mlp.fc2", F.silu(u) * v))


def backbone(cfg: dict, p: dict, x, train: bool, q):
    """(N, 3, S, S) -> (N, embed_dim) class-token features; ``train`` changes
    nothing (no BatchNorm, no dropout)."""
    _check(cfg)
    if tuple(x.shape[-2:]) != (cfg["img_size"],) * 2:
        raise ValueError(f"the ViT takes {cfg['img_size']}^2 images; got {tuple(x.shape[-2:])}")
    d, g = cfg["embed_dim"], lambda name: p[f"net.model.{name}"]
    t = q(F.conv2d(q(x), q(g("patch_embed.proj.weight")), g("patch_embed.proj.bias"), stride=cfg["patch_size"]))
    t = t.flatten(2).transpose(1, 2) + g("pos_embed")
    n = t.shape[0]
    t = torch.cat([g("cls_token").expand(n, -1, -1), g("reg_token").expand(n, -1, -1), t], dim=1)
    for i in range(cfg["depth"]):
        if torch.is_grad_enabled():
            t = checkpoint(_block, cfg, p, f"blocks.{i}.", q, t, use_reentrant=False)
        else:
            t = _block(cfg, p, f"blocks.{i}.", q, t)
    return q(F.layer_norm(t[:, 0], (d,), g("norm.weight"), g("norm.bias"), eps=cfg["ln_eps"]))


def backbone_macs(cfg: dict, size: int) -> tuple:
    """(multiply-adds of one image's forward at ``size``^2, those of its
    patch embedding): the patch embedding, then each block's qkv, QK^T, PV,
    proj, fc1 and fc2."""
    if size != cfg["img_size"]:
        raise ValueError(f"the ViT takes {cfg['img_size']}^2 images (position embeddings for {patches(cfg)} "
                         f"patches); a mix at {size}^2 does not fit it")
    d, t, h = cfg["embed_dim"], tokens(cfg), hidden(cfg)
    first = patches(cfg) * d * 3 * cfg["patch_size"] ** 2
    block = t * (3 * d * d + d * d + d * h + (h // 2) * d) + 2 * t * t * d
    return first + cfg["depth"] * block, first


def attention_flops(cfg: dict, views: int) -> tuple:
    """(forward, backward) FLOPs of one block's attention kernels over
    ``views`` views: QK^T and PV forward, 4 V H T^2 d; backward 10 V H T^2 d,
    the fused backward recomputing QK^T besides its four products."""
    unit = views * cfg["num_heads"] * tokens(cfg) ** 2 * (cfg["embed_dim"] // cfg["num_heads"])
    return 4.0 * unit, 10.0 * unit

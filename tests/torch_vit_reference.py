"""A plain functional UNI2-h forward: the reference the port's ViT
(``ssl_cr_histo_tpu_torch/models/vit.py``) is held to in the CPU tests.

Plain ``torch`` only; it imports nothing of the port and nothing of JAX,
and runs in the dtype of its inputs (float64 or float32).  Written from
the model card's timm arguments (``vit_giant_patch14_224``, reg_tokens 8,
no_embed_class, SwiGLUPacked, SiLU, init_values; timm's defaults: LayerNorm
eps 1e-6, qkv_bias, class-token pooling after the final norm):

- patches: each ``patch``^2 x 3 patch flattened (channel, row, column) and
  multiplied by the patch embedding's weight, plus its bias;
- the position embeddings added to the patch tokens, then the class token
  and the register tokens put before them;
- each block ``x + ls1 * attn(norm1(x))``, ``x + ls2 * mlp(norm2(x))``;
  attention softmax(Q K^T / sqrt(d)) V over heads of d, written out; the
  MLP ``fc2(silu(a) * b)`` with ``a``, ``b`` the first and second halves of
  ``fc1``'s output, silu(a) = a * sigmoid(a);
- LayerNorm written out: (x - mean) / sqrt(biased variance + eps);
- the class token's final LayerNorm is the feature.

``p`` holds the backbone's tensors under timm's names (the port's
backbone state_dict); ``cfg`` the widths: ``img_size``, ``patch_size``,
``embed_dim``, ``depth``, ``num_heads``, ``mlp_ratio``, ``reg_tokens``.
"""

import math

import torch

EPS = 1e-6


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def linear(p, name, x):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def attention(p, pre, x, heads):
    n, t, d = x.shape
    hd = d // heads
    q, k, v = linear(p, f"{pre}attn.qkv", x).reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    return linear(p, f"{pre}attn.proj", (weights @ v).transpose(1, 2).reshape(n, t, d))


def mlp(p, pre, x):
    a, b = linear(p, f"{pre}mlp.fc1", x).chunk(2, dim=-1)
    return linear(p, f"{pre}mlp.fc2", a * torch.sigmoid(a) * b)


def block(p, pre, x, heads):
    x = x + p[f"{pre}ls1.gamma"] * attention(p, pre, layer_norm(x, p[f"{pre}norm1.weight"], p[f"{pre}norm1.bias"]),
                                             heads)
    return x + p[f"{pre}ls2.gamma"] * mlp(p, pre, layer_norm(x, p[f"{pre}norm2.weight"], p[f"{pre}norm2.bias"]))


def forward(p, x, cfg):
    """(N, 3, S, S) images -> (N, embed_dim) class-token features."""
    n, ps, d = x.shape[0], cfg["patch_size"], cfg["embed_dim"]
    g = cfg["img_size"] // ps
    patches = x.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, 3 * ps * ps)
    t = patches @ p["patch_embed.proj.weight"].reshape(d, -1).T + p["patch_embed.proj.bias"] + p["pos_embed"]
    t = torch.cat([p["cls_token"].expand(n, -1, -1), p["reg_token"].expand(n, -1, -1), t], dim=1)
    for i in range(cfg["depth"]):
        t = block(p, f"blocks.{i}.", t, cfg["num_heads"])
    return layer_norm(t[:, 0], p["norm.weight"], p["norm.bias"])

"""UNI2-h's backbone: a ViT-giant with register tokens, packed SwiGLU and
LayerScale, as timm's ``VisionTransformer`` builds it from the model card's
arguments (Chen et al. 2024, UNI, Nature Medicine;
huggingface.co/MahmoodLab/UNI2-h: ``vit_giant_patch14_224``, ``img_size``
224, ``patch_size`` 14, ``embed_dim`` 1536, ``depth`` 24, ``num_heads`` 24,
``mlp_ratio`` 5.33334, ``mlp_layer`` SwiGLUPacked, ``act_layer`` SiLU,
``reg_tokens`` 8, ``no_embed_class`` True, ``init_values`` 1e-5,
``num_classes`` 0).  Module and parameter names are timm's
(``patch_embed.proj``, ``cls_token``, ``reg_token``, ``pos_embed``,
``blocks.{i}.norm1``, ``.attn.qkv``, ``.attn.proj``, ``.ls1.gamma``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``.ls2.gamma``, ``norm``), so the
published state_dict loads unchanged, and so is the order of
``parameters()`` (``train.freeze``'s index space).

forward(x (B, 3, 224, 224)) -> (B, 1536): the patches (a 14x14 stride-14
convolution, 256 tokens) plus their position embeddings (the patch tokens
only), after the class token and the 8 register tokens; 24 pre-LN blocks
``x + ls1(attn(norm1(x)))``, ``x + ls2(mlp(norm2(x)))``; the final
LayerNorm (eps 1e-6, as every LayerNorm here) of the class token.
Attention: 24 heads of 64, ``qkv`` with bias, softmax(QK^T / 8) V through
``F.scaled_dot_product_attention``.  MLP (SwiGLUPacked, timm's ``GluMlp``
with ``gate_last`` False): ``fc1`` 1536 -> 8192 split into gate and value
halves, ``fc2(silu(gate) * value)`` 4096 -> 1536.  LayerScale:
``x * gamma``.

Precision: under bfloat16 autocast the matrix products run in bfloat16,
the LayerNorms in float32, and LayerScale's float32 ``gamma`` promotes
each branch back to float32, so the residual stream stays float32.  On
CUDA with bfloat16 (or float16) inputs attention is pinned to the flash
backend (``torch.nn.attention.sdpa_kernel``): where flash cannot take the
inputs the call raises, instead of falling back to a backend that keeps the
(B, 24, 265, 265) scores.  Elsewhere (the CPU, float32, float64) the math
backend runs.  ``attention_calls``, a ``collections.Counter`` on the
model, counts attention calls by the backend that served them; it counts
in Python, so eager steps and a CUDA graph's capture, not its replays
(``read_counters``).
Each attention and MLP branch is the span ``port.vit.attention`` /
``port.vit.mlp`` (``utils.profiling.span``).

Initialisation, timm's default (``init_weights('')``): every Linear weight
from a normal of std 0.02 truncated to [-2, 2], its bias 0;
``pos_embed`` as a Linear weight, ``cls_token`` and ``reg_token`` from a
normal of std 1e-6; the patch convolution as ``nn.Conv2d`` initialises
itself; LayerNorm 1 and 0; LayerScale ``init_values``.  Draws from torch's
global generator.

``remat`` recomputes each block in the backward pass of a training forward
(``torch.utils.checkpoint`` without re-entry; a block has no state and no
randomness, so the recomputation is exact).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from ssl_cr_histo_tpu_torch.utils.profiling import span

# the model card's arguments that fix the shapes
CONFIGS = {
    "uni2h": dict(img_size=224, patch_size=14, embed_dim=1536, depth=24, num_heads=24, mlp_ratio=5.33334,
                  reg_tokens=8, init_values=1e-5),
}
LN_EPS = 1e-6
_FLASH_DTYPES = (torch.bfloat16, torch.float16)


def sdpa_backend(q: torch.Tensor) -> SDPBackend:
    """The one backend attention may run on for ``q``: flash on CUDA in
    bfloat16 or float16, else math."""
    return SDPBackend.FLASH_ATTENTION if q.is_cuda and q.dtype in _FLASH_DTYPES else SDPBackend.MATH


class PatchEmbed(nn.Module):
    def __init__(self, img_size: int, patch_size: int, dim: int):
        super().__init__()
        self.img_size = img_size
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)

    def forward(self, x):
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            raise ValueError(f"the ViT takes {self.img_size}^2 images (its position embeddings are for "
                             f"{self.num_patches} patches); got {tuple(x.shape[-2:])}")
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, calls: collections.Counter):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.calls = calls

    def forward(self, x):
        b, t, d = x.shape
        with span("vit.attention"):
            q, k, v = self.qkv(x).reshape(b, t, 3, self.num_heads, d // self.num_heads).permute(2, 0, 3, 1, 4)
            backend = sdpa_backend(q)
            self.calls[backend.name] += 1
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(q, k, v)
            return self.proj(o.transpose(1, 2).reshape(b, t, d))


class GluMlp(nn.Module):
    """timm's SwiGLUPacked: ``fc2(silu(gate) * value)``, gate the first half
    of ``fc1``'s output."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, x):
        with span("vit.mlp"):
            gate, value = self.fc1(x).chunk(2, dim=-1)
            return self.fc2(F.silu(gate) * value)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(init_values * torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, init_values: float, calls: collections.Counter):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, calls)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = GluMlp(dim, hidden)
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class ViT(nn.Module):
    """forward(x (B, 3, S, S)) -> (B, embed_dim) class-token features,
    float32 (float64 for a float64 model); see the module docstring."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, reg_tokens: int, init_values: float, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.attention_calls = collections.Counter()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.reg_token = nn.Parameter(torch.zeros(1, reg_tokens, embed_dim))
        self.patch_embed = PatchEmbed(img_size, patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.patch_embed.num_patches, embed_dim))
        hidden = int(embed_dim * mlp_ratio)  # timm's rounding: 8192 for UNI2-h
        self.blocks = nn.Sequential(*(Block(embed_dim, num_heads, hidden, init_values, self.attention_calls)
                                      for _ in range(depth)))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        nn.init.normal_(self.cls_token, std=1e-6)
        nn.init.normal_(self.reg_token, std=1e-6)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, -1, -1), self.reg_token.expand(b, -1, -1), x], 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False) if remat else block(x)
        # LayerNorm is per token: the class token's alone is the pooled feature
        x = self.norm(x[:, 0])
        return x.to(torch.promote_types(x.dtype, torch.float32))


def read_counters(model: nn.Module) -> dict:
    """The family's counters in ``model``, for the epoch line
    (``models.nets.read_counters``): ``{"attention calls": ...}``, the
    attention calls of every ViT inside it by SDPA backend, named in lower
    case; empty for a model without one."""
    vits = [m for m in model.modules() if isinstance(m, ViT)]
    if not vits:
        return {}
    calls = sum((m.attention_calls for m in vits), collections.Counter())
    return {"attention calls": collections.Counter({k.lower(): v for k, v in calls.items()})}

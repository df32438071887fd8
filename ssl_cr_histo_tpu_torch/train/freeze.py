"""Reference-compatible parameter freezing for fine-tuning.

Counterpart of ``ssl_cr_histo_tpu/train/freeze.py:36-100``.  The reference
freezes by torch parameter enumeration index: the first ``--modules``
tensors of ``model.parameters()`` get ``requires_grad=False``
(eval_BreastPathQ_SSL.py:361-370).  Operating points for the
TripletNet(resnet18): 0 full fine-tune, 3 conv1 + bn1, 15 through layer1,
30 through layer2, 45 through layer3, 60 the whole backbone, 64 backbone and
pairwise fc (the head alone trains).  For the TripletNet(uni2h), in timm's
parameter order (``models/vit.py``; 14 tensors a block): 0 full fine-tune,
5 the patch embedding and the tokens (``cls_token``, ``reg_token``,
``pos_embed``, ``patch_embed.proj``), 5 + 14 (i + 1) through block i (19
through block 0, 341 through block 23), 343 the whole backbone (the final
``norm`` too), 347 backbone and pairwise fc.

A frozen tensor takes no gradient, so the optimizer gives it neither an
update nor weight decay.  A ResNet's BatchNorm running statistics are
buffers, not parameters: they go on updating in train mode, as in the
reference, which never puts frozen modules in eval mode.
"""

from __future__ import annotations

from typing import List

from torch import nn


def torch_param_order(model: nn.Module) -> List[str]:
    """The names of ``model.parameters()`` in their enumeration order: the
    index space of ``--modules``."""
    return [name for name, _ in model.named_parameters()]


def freeze(model: nn.Module, modules: int) -> List[str]:
    """Switch off ``requires_grad`` on the first ``modules`` tensors of
    ``model.parameters()``; returns their names."""
    frozen = []
    for name, p in list(model.named_parameters())[:max(modules, 0)]:
        p.requires_grad_(False)
        frozen.append(name)
    return frozen

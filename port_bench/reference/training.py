"""The reference's training steps: plain PyTorch in float32 (TF32 off),
autograd for the gradients, the optimizers written out.

Each ``follow_*`` takes the configuration, the traffic's parameters, the
seed's weights (``port_bench.weights``), the inputs the benchmark made and
the seed of the step's generator, runs ``steps`` steps and returns the
numbers ``port_bench.compare`` reads: each step's loss, each leaf's norm of
the first gradient as the optimizer gets it (weight decay added), and each
leaf's norm of its change over the steps.

``quant`` (``nets.fp8_train``) puts the control's lower precision into
every tensor the program keeps in bfloat16; ``rows`` keeps only the first rows of
each step's batch after the draws (a fault: half of the batch left out);
``bf16`` runs the layers under bfloat16 autocast, as the program does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import augment, augment_fix
from port_bench.reference.nets import Net

# every other kind of tensor is trained
UNTRAINED = ("bn_mean", "bn_var", "bn_count")


def _setup_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _norms(ts: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in ts.items()}


class SGDNesterov:
    """torch's SGD(momentum, nesterov, weight_decay): d = g + wd p; buf = d
    on the first step, else m buf + d; p -= lr (d + m buf)."""

    def __init__(self, lr, momentum, weight_decay):
        self.lr, self.m, self.wd = lr, momentum, weight_decay
        self.buf = {}

    def step(self, params: dict, grads: dict) -> dict:
        seen = {}
        with torch.no_grad():
            for k, p in params.items():
                d = grads[k] + self.wd * p
                seen[k] = d
                self.buf[k] = d.clone() if k not in self.buf else self.buf[k].mul_(self.m).add_(d)
                p.sub_(self.lr * (d + self.m * self.buf[k]))
        return seen


class AdamL2:
    """torch's Adam(weight_decay) without amsgrad: d = g + wd p, the moments
    of d, bias-corrected, p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, betas[0], betas[1], eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        seen = {}
        with torch.no_grad():
            for k, p in params.items():
                d = grads[k] + self.wd * p
                seen[k] = d
                m = self.m.setdefault(k, torch.zeros_like(p)).mul_(self.b1).add_(d, alpha=1 - self.b1)
                v = self.v.setdefault(k, torch.zeros_like(p)).mul_(self.b2).addcmul_(d, d, value=1 - self.b2)
                m_hat = m / (1 - self.b1 ** self.t)
                v_hat = v / (1 - self.b2 ** self.t)
                p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return seen


def _run(cfg, spec, weights, optimizer, loss_of, steps: int) -> dict:
    """Shared loop: ``loss_of(net, step)`` gives a step's loss."""
    _setup_precision()
    trained = [e[0] for e in spec if e[2] not in UNTRAINED]
    p = {k: v.detach().clone() for k, v in weights.items()}
    start = {k: p[k].clone() for k in trained}
    losses, first = [], None
    for s in range(steps):
        for k in trained:
            p[k].requires_grad_(True)
        loss = loss_of(p, s)
        grads = dict(zip(trained, torch.autograd.grad(loss, [p[k] for k in trained])))
        for k in trained:
            p[k].requires_grad_(False)
        seen = optimizer.step({k: p[k] for k in trained}, grads)
        losses.append(float(loss.detach()))
        if first is None:
            first = _norms(seen)
        del loss, grads, seen
    return {"loss": losses, "grad": first, "update": _norms({k: p[k] - start[k] for k in trained})}


def follow_pretrain(cfg, traffic, spec, weights, triplets, gen_seed, steps=3, quant=None, rows=None,
                    bf16=False) -> dict:
    """RSP pretraining steps on (steps, B, 3, S, S, 3) uint8 triplets on
    the device: the orderings and views drawn as the step draws them, one
    backbone pass over the B*3 views, pair head, classifier, cross-entropy,
    SGD-Nesterov."""
    gen = torch.Generator(device=triplets.device).manual_seed(gen_seed)
    opt = SGDNesterov(traffic["lr"], traffic["momentum"], traffic["weight_decay"])

    def loss_of(p, s):
        labels, views = augment.rsp_views(gen, triplets[s])
        if rows is not None:
            labels, views = labels[:rows], views[:rows]
        net = Net(cfg, p, quant)
        with torch.autocast(views.device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = net.rsp_logits(net.triplet_features(views))
        return F.cross_entropy(logits.float(), labels)

    return _run(cfg, spec, weights, opt, loss_of, steps)


def follow_finetune(cfg, traffic, spec, weights, images, labels, gen_seed, steps=3, quant=None, rows=None,
                    bf16=False) -> dict:
    """Fine-tune steps on (steps, B, S, S, 3) uint8 images and (steps, B)
    labels on the device: the 3-view stack, ``encode_single`` over the B*3
    views, the head, cross-entropy over each view with its image's label,
    Adam with L2."""
    gen = torch.Generator(device=images.device).manual_seed(gen_seed)
    opt = AdamL2(traffic["lr"], traffic["weight_decay"])

    def loss_of(p, s):
        views = augment.three_view_stack(gen, images[s])
        y = labels[s].long()
        if rows is not None:
            views, y = views[:rows], y[:rows]
        b = views.shape[0]
        net = Net(cfg, p, quant)
        with torch.autocast(views.device.type, dtype=torch.bfloat16, enabled=bf16):
            out = net.head(net.single_features(views.reshape(b * 3, *views.shape[2:])))
        return F.cross_entropy(out.float(), y.repeat_interleave(3))

    return _run(cfg, spec, weights, opt, loss_of, steps)


def follow_consistency(cfg, traffic, spec, weights, x_l, y_l, x_u, gen_seed, host_seed, steps=3, quant=None,
                       rows=None, bf16=False) -> dict:
    """Consistency steps on (steps, B, S, S, 3) labeled uint8 images, their
    (steps, B) labels and (steps, mu B, S, S, 3) unlabeled images: the weak
    and strong views, the labeled 3-view stack; the teacher (the starting
    weights, BatchNorm on its running statistics) on the weak views; the
    student over the labeled and strong views in one pass; cross-entropy on
    the labels plus ``lambda_u`` times cross-entropy of the strong views
    against the teacher's argmax; SGD-Nesterov."""
    gen = torch.Generator(device=x_l.device).manual_seed(gen_seed)
    host_gen = torch.Generator().manual_seed(host_seed)
    opt = SGDNesterov(traffic["lr"], traffic["momentum"], traffic["weight_decay"])
    teacher = Net(cfg, {k: v.detach().clone() for k, v in weights.items()}, quant)

    def loss_of(p, s):
        weak, strong = augment_fix.weak_strong(gen, host_gen, x_u[s], traffic["n_aug"], traffic["m_aug"])
        stacks = augment.three_view_stack(gen, x_l[s])
        y = y_l[s].long().repeat_interleave(3)
        lab = stacks.reshape(-1, *stacks.shape[2:])
        if rows is not None:
            lab, y = lab[:3 * rows], y[:3 * rows]
            weak, strong = weak[:rows * traffic["mu"]], strong[:rows * traffic["mu"]]
        net = Net(cfg, p, quant)
        with torch.no_grad(), torch.autocast(weak.device.type, dtype=torch.bfloat16, enabled=bf16):
            out_w = teacher.head(teacher.single_features(weak, train=False)).float()
        with torch.autocast(weak.device.type, dtype=torch.bfloat16, enabled=bf16):
            out = net.head(net.single_features(torch.cat([lab, strong]))).float()
        out_l, out_s = out[:lab.shape[0]], out[lab.shape[0]:]
        sup = F.cross_entropy(out_l, y)
        cons = F.cross_entropy(out_s, torch.argmax(torch.softmax(out_w, -1), -1))
        return sup + traffic["lambda_u"] * cons

    return _run(cfg, spec, weights, opt, loss_of, steps)

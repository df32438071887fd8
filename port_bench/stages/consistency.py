"""Consistency (teacher-student) training, as the consistency CLI's loop
runs it (``ssl_cr_histo_tpu_torch/cli/consistency.py``): labeled and
unlabeled batches zipped -> ``cli.common.chunked_feed`` -> ``parallel.
steps.make_consistency_multi_step(...).run``, K steps a chunk; each step's
weak and strong views eager (``ops.batch.transform_fix_batch``), the rest
a replay of the captured graph; the teacher refreshed from the student at
the start, as at each epoch's start.

The mix's parameters: ``labeled`` images of ``size``^2 a step in
``classes`` classes, balanced, and ``mu`` times as many unlabeled ones;
the strong pool's ``n_aug`` stages at magnitudes under ``m_aug`` in
``aug_mode``; ``lambda_u``; ``k`` steps a chunk; bf16; the task's
optimizer (``optimizer``, ``lr``, ``momentum``, ``weight_decay``); the
first ``modules`` tensors of the student frozen; ``distinct_steps`` seeded
batches made in set-up and fed in a cycle.

Seeds: the weights from ``seed``, the step's device and host generators
from ``seed + 1``, the images and labels from ``seed + 2``.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from port_bench import yardstick
from port_bench.reference import training
from port_bench.reference.nets import param_spec
from port_bench.stages.common import StageBase, finetune_state, follow_first_chunk, seeded_images
from port_bench.weights import make_weights

FOLLOWED = 3


class Stage(StageBase):
    batch_key = "labeled"

    def prepare(self):
        """The batches both sides read; the work a step counts."""
        tr = self.traffic
        b, size, classes, n = tr["labeled"], tr["size"], tr["classes"], tr["distinct_steps"]
        bu = b * tr["mu"]
        self.work_per_step = float(b + bu)
        self.flops_per_step = yardstick.consistency_step_flops(self.cfg, 3 * b + bu, bu, size, classes)
        self.spec = param_spec(self.cfg, head_classes=classes)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        self.x_l = seeded_images(gen, n * b, size).reshape(n, b, size, size, 3)
        self.x_u = seeded_images(gen, n * bu, size).reshape(n, bu, size, size, 3)
        # each step's labels balanced over the classes, in a seeded order
        order = torch.argsort(torch.rand(n, b, generator=gen, device=self.device), dim=1).cpu().numpy()
        self.y_l = (order % classes).astype(np.int64)

    def setup(self):
        from ssl_cr_histo_tpu_torch.cli.common import chunked_feed, resolve_device
        from ssl_cr_histo_tpu_torch.parallel import steps as S
        from ssl_cr_histo_tpu_torch.train.init import init_teacher

        tr, dev = self.traffic, self.device
        resolve_device(argparse.Namespace(device=str(dev)))
        self.prepare()
        self.mark("data")
        weights = make_weights(self.spec, self.seed, dev)
        self._sync()
        self.mark("weights")
        state, params = finetune_state(self, weights)
        if tr["optimizer"] == "sgd" and state.optimizer.param_groups[0]["momentum"] != tr["momentum"]:
            raise ValueError("the program's SGD momentum differs from the mix's")
        teacher = S.refresh_teacher(init_teacher(state), state)
        self.state, self.teacher = state, teacher
        self._sync()
        self.mark("state")
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        host_gen = torch.Generator().manual_seed(self.seed + 1)
        self.step = S.make_consistency_multi_step(state, teacher, gen, tr["k"], "classification", tr["lambda_u"],
                                                  tr["n_aug"], host_gen=host_gen, aug_mode=tr["aug_mode"],
                                                  bf16=tr["bf16"], global_batch=tr["labeled"])
        self.mark("step")
        labeled = itertools.cycle(list(zip(self.x_l, self.y_l)))
        unlabeled = itertools.cycle([(x,) for x in self.x_u])
        self.feed = chunked_feed(dev, tr["k"], labeled, unlabeled)
        chunk, n = next(self.feed)
        self.prog = follow_first_chunk(self, chunk, n, params, weights, FOLLOWED)
        del weights, params
        self._sync()
        self.mark("first chunk")

    def reference(self, quant=None, rows=None, bf16=False) -> dict:
        weights = make_weights(self.spec, self.seed, self.device)
        dev = lambda a: torch.from_numpy(a[:FOLLOWED]).to(self.device)
        return training.follow_consistency(self.cfg, self.traffic, self.spec, weights, dev(self.x_l), dev(self.y_l),
                                           dev(self.x_u), self.seed + 1, self.seed + 1, FOLLOWED, quant=quant,
                                           rows=rows, bf16=bf16)

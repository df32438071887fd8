"""Supervised fine-tuning, as the fine-tune CLI's loop runs it
(``ssl_cr_histo_tpu_torch/cli/finetune.py``): labeled batches ->
``cli.common.chunked_feed`` -> ``parallel.steps.make_finetune_multi_step
(...).run``, K steps a chunk, the 3-view stack inside the captured step.

The mix's parameters: ``batch`` images of ``size``^2 a step with labels in
``classes`` classes, ``k`` steps a chunk, bf16, the task's optimizer
(``optimizer``, ``lr``, ``weight_decay``; the CLI's ``make_optimizer``),
the first ``modules`` tensors frozen; ``distinct_steps`` seeded batches
made in set-up and fed in a cycle.

Seeds: the weights from ``seed``, the step's generator from ``seed + 1``,
the images and labels from ``seed + 2``.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from port_bench import yardstick
from port_bench.reference import training
from port_bench.reference.nets import param_spec
from port_bench.stages.common import StageBase, finetune_state, follow_first_chunk, seeded_images
from port_bench.weights import make_weights

FOLLOWED = 3


class Stage(StageBase):
    batch_key = "batch"

    def prepare(self):
        """The batches both sides read; the work a step counts."""
        tr = self.traffic
        b, size, classes = tr["batch"], tr["size"], tr["classes"]
        self.work_per_step = 3.0 * b
        self.flops_per_step = yardstick.finetune_step_flops(self.cfg, 3 * b, size, classes)
        self.spec = param_spec(self.cfg, head_classes=classes)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        n = tr["distinct_steps"]
        self.images = seeded_images(gen, n * b, size).reshape(n, b, size, size, 3)
        self.labels = torch.randint(0, classes, (n, b), generator=gen, device=self.device).cpu().numpy()

    def setup(self):
        from ssl_cr_histo_tpu_torch.cli.common import chunked_feed, resolve_device
        from ssl_cr_histo_tpu_torch.parallel import steps as S

        tr, dev = self.traffic, self.device
        resolve_device(argparse.Namespace(device=str(dev)))
        self.prepare()
        self.mark("data")
        weights = make_weights(self.spec, self.seed, dev)
        self._sync()
        self.mark("weights")
        self.state, params = finetune_state(self, weights)
        self._sync()
        self.mark("state")
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.step = S.make_finetune_multi_step(self.state, gen, tr["k"], "classification", bf16=tr["bf16"],
                                               global_batch=tr["batch"])
        self.mark("step")
        batches = itertools.cycle(list(zip(self.images, self.labels)))
        self.feed = chunked_feed(dev, tr["k"], batches)
        chunk, n = next(self.feed)
        self.prog = follow_first_chunk(self, chunk, n, params, weights, FOLLOWED)
        del weights, params
        self._sync()
        self.mark("first chunk")

    def reference(self, quant=None, rows=None, bf16=False) -> dict:
        weights = make_weights(self.spec, self.seed, self.device)
        images = torch.from_numpy(self.images[:FOLLOWED]).to(self.device)
        labels = torch.from_numpy(self.labels[:FOLLOWED]).to(self.device)
        return training.follow_finetune(self.cfg, self.traffic, self.spec, weights, images, labels, self.seed + 1,
                                        FOLLOWED, quant=quant, rows=rows, bf16=bf16)

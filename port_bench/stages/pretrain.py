"""RSP pretraining, as the pretrain CLI's loop runs it
(``ssl_cr_histo_tpu_torch/cli/pretrain.py``): ``RSPTripletSampler.
iter_batches`` over the slides -> ``cli.common.chunked_feed`` ->
``parallel.steps.make_pretrain_multi_step(...).run``, K steps a chunk.

The mix's parameters: ``batch`` triplets of ``tile``^2 a step, ``k`` steps
a chunk, the v1 pool in ``aug_mode``, joint encode, bf16, SGD-Nesterov
(``lr``, ``momentum``, ``weight_decay``); the slide set (``port_bench.
slides``) with triplet positions every ``stride`` LR2 pixels, read by
``read_workers`` threads (0: the feed's own thread), and with
``cache_tiles`` (the CLI's ``--cache_tiles``) every triplet kept in RAM
after its first read, all of them read in set-up.  Epochs follow one
another without a pause (the CLI's validation between them is not run).

Seeds: the weights from ``seed``, the step's generator from ``seed + 1``,
epoch e's shuffle from ``seed + 2 + e``.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from port_bench import compare, yardstick
from port_bench.reference import feed as ref_feed
from port_bench.reference import training
from port_bench.reference.nets import param_spec
from port_bench.slides import ensure_slides
from port_bench.stages.common import StageBase, follow_first_chunk, named_params
from port_bench.weights import make_weights, prefixed

RSP_CLASSES = 6
FOLLOWED = 3


class Stage(StageBase):
    batch_key = "batch"

    def prepare(self):
        """What both sides read: the slide files; the work a step counts."""
        tr = self.traffic
        self.work_per_step = 3.0 * tr["batch"]
        self.flops_per_step = yardstick.pretrain_step_flops(self.cfg, tr["batch"], tr["tile"], RSP_CLASSES)
        self.slide_dir = ensure_slides(self.root, tr)
        self.spec = param_spec(self.cfg, rsp_classes=RSP_CLASSES)

    def setup(self):
        from ssl_cr_histo_tpu_torch.cli.common import chunked_feed, resolve_device
        from ssl_cr_histo_tpu_torch.data.sampler import RSPTripletSampler
        from ssl_cr_histo_tpu_torch.data.wsi import ReaderCache
        from ssl_cr_histo_tpu_torch.parallel import steps as S
        from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

        tr, cfg, dev = self.traffic, self.cfg, self.device
        # the stage CLIs' device set-up: TF32 off for matmuls and cuDNN
        resolve_device(argparse.Namespace(device=str(dev)))
        b, k = tr["batch"], tr["k"]
        if k <= FOLLOWED:
            raise ValueError(f"k = {k}: the first chunk has to hold the {FOLLOWED} followed steps and more")
        self.prepare()
        sampler = RSPTripletSampler(tile=tr["tile"], stride=tr["stride"], geometry="v1")
        indices = sampler.index_directory(self.slide_dir)
        self.positions = sum(len(i.coords) for i in indices)
        self.mark("slides")
        weights = make_weights(self.spec, self.seed, dev)
        self._sync()
        self.mark("weights")
        # the modules made on the card: the seeded weights replace their
        # initial values, which the host's CPU would take seconds to draw
        with torch.device(dev):
            state = init_triplet_state(cfg["program_model"], dev, lr=tr["lr"], weight_decay=tr["weight_decay"])
        state.model.load_state_dict(prefixed(weights, "net"))
        state.classifier.load_state_dict(prefixed(weights, "clf"))
        if state.optimizer.param_groups[0]["momentum"] != tr["momentum"]:
            raise ValueError("the program's SGD momentum differs from the mix's")
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        host_gen = torch.Generator().manual_seed(self.seed + 1)
        self.state = state
        self._sync()
        self.mark("state")
        self.step = S.make_pretrain_multi_step(state, gen, k, augment="v1", aug_mode=tr["aug_mode"],
                                               host_gen=host_gen, joint_encode=True, bf16=tr["bf16"],
                                               global_batch=b)
        self.mark("step")
        readers = ReaderCache(capacity=64)
        tile_cache = {} if tr["cache_tiles"] else None
        if tile_cache is not None:
            # the CLI's --cache_tiles (the reference's tiles all in RAM):
            # every position read once here, so that the window reads none
            for _ in sampler.iter_batches(indices, b, drop_last=False, readers=readers, tile_cache=tile_cache):
                pass
        self.mark("tile cache")
        epochs = itertools.chain.from_iterable(
            sampler.iter_batches(indices, b, seed=self.seed + 2 + e, readers=readers, tile_cache=tile_cache,
                                 read_workers=tr["read_workers"]) for e in itertools.count())
        self.feed = chunked_feed(dev, k, ((t,) for t in epochs))

        # the first chunk: the followed steps through run(), the program's
        # readings between them, then the rest of the chunk
        chunk, n = next(self.feed)
        self.fed = chunk[0][:FOLLOWED].cpu()
        params = {**named_params(state.model, "net"), **named_params(state.classifier, "clf")}
        self.prog = follow_first_chunk(self, chunk, n, params, weights, FOLLOWED)
        del weights, params
        self._sync()
        self.mark("first chunk")

    def reference(self, quant=None, rows=None, bf16=False) -> dict:
        """The reference's three steps from its own reading of the slides."""
        triplets = ref_feed.first_batches(self.slide_dir, self.traffic, self.seed + 2, FOLLOWED)
        self.ref_fed = triplets
        weights = make_weights(self.spec, self.seed, self.device)
        return training.follow_pretrain(self.cfg, self.traffic, self.spec, weights,
                                        torch.from_numpy(triplets).to(self.device), self.seed + 1,
                                        FOLLOWED, quant=quant, rows=rows, bf16=bf16)

    def check(self) -> dict:
        """The compared numbers (``port_bench.compare``)."""
        ref = self.reference()
        fed = self.fed.numpy()
        same = (fed == self.ref_fed).reshape(fed.shape[0] * fed.shape[1], -1).all(1)
        out = compare.training_gaps(self.prog, ref)
        out["feed_mismatch"] = (float((~same).sum()), f"of {same.size} triplets")
        return out

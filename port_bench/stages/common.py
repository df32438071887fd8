"""What every training stage's driver shares: the measured window, the
traced stretch, the release of the program's state, the check.

A driver (``port_bench/stages/<stage>.py``, named by a mix's ``stage``)
defines ``Stage`` with ``prepare()``, which makes what both sides read and
sets ``work_per_step`` and ``flops_per_step``; ``setup()``, which builds
the program's training state (``self.state``), step (``self.step``, a
``StepGraph``) and feed (``self.feed``, ``cli.common.chunked_feed``'s
iterator) and runs the first chunk, the program's readings taken among its
first steps (``self.prog``), with ``mark`` after each of its steps;
``reference(quant, rows, bf16)``, the
reference's readings of the same steps; and ``batch_key``, the mix's key
of the rows a step takes (which the half-batch fault halves).
"""

from __future__ import annotations

import time

import torch

from port_bench import tracing
from port_bench.weights import prefixed


class StageBase:
    work_per_step = 0.0
    flops_per_step = 0.0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, root: str):
        self.cfg, self.traffic, self.seed, self.device, self.root = cfg, traffic, seed, device, root
        self.step = self.feed = self.state = self.teacher = None
        self.marks = []

    def mark(self, name: str):
        """Note the end of set-up's step ``name`` (printed by the run)."""
        self.marks.append((name, time.time()))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        """Run whole chunks from the feed until ``seconds`` have passed,
        then wait for the card.  The loop is the stage CLIs': each step's
        loss added to a sum on the card, the sum read back every
        ``print_freq`` steps.  Returns the steps, the wall seconds from the
        first ``next()`` to the end of the last step, the seconds spent in
        ``next()`` (and of them those after a read-back, when the card waits
        on the feed) and the steps whose loss was not finite."""
        self._sync()
        every = self.traffic["print_freq"]
        loss_sum = torch.zeros((), device=self.device)
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        steps, wait, drained_wait, drained = 0, 0.0, 0.0, False
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            chunk, n = next(self.feed)
            wait += time.perf_counter() - t
            if drained:
                # the card has nothing queued while this next() waits
                drained_wait += time.perf_counter() - t
                drained = False
            out = self.step.run(chunk, n)
            for i in range(n):
                loss_sum += out["loss"][i]
                steps += 1
                if steps % every == 0:
                    float(loss_sum)
                    drained = True
            bad += (~torch.isfinite(out["loss"][:n])).sum()
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        return {"steps": steps, "wall_s": wall, "feed_wait_s": wait, "drained_wait_s": drained_wait,
                "failed": int(bad)}

    def traced(self, chunks: int) -> dict:
        """``chunks`` more chunks under torch.profiler (after one more that
        it does not read), each ``next()`` and ``run`` in a span of its own;
        returns ``tracing.summarize``'s numbers and the fused kernel's
        launches by its wrapper's counter."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        steps = 0
        self._sync()
        with profile(activities=acts) as prof:
            # one chunk before the stretch, so that the profiler's own start
            # falls outside it
            self.step.run(*next(self.feed))
            self._sync()
            launches = RK.launches
            with record_function(tracing.STRETCH):
                for _ in range(chunks):
                    with record_function("bench.feed_next"):
                        chunk, n = next(self.feed)
                    with record_function("bench.step_run"):
                        self.step.run(chunk, n)
                    steps += n
                self._sync()
            launches = RK.launches - launches
        out = tracing.summarize(tracing.kineto_events(prof), steps)
        # the kernel wrapper's own counter (graph replays credited)
        out["rsp_augment_launches"] = launches
        return out

    def release(self):
        """Stop the feed's threads and free the program's state."""
        if self.feed is not None:
            self.feed.close()
        self.step = self.feed = self.state = self.teacher = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The compared numbers (``port_bench.compare``)."""
        from port_bench import compare

        return compare.training_gaps(self.prog, self.reference())


def named_params(module: torch.nn.Module, prefix: str) -> dict:
    return {f"{prefix}.{k}": p for k, p in module.named_parameters()}


def norms(ts: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in ts.items()}


def seeded_images(gen: torch.Generator, n: int, size: int, block: int = 256):
    """(n, size, size, 3) uint8 host images made on ``gen``'s device in
    blocks: a smooth random colour field (8x8, upsampled bilinearly) with
    pixel noise, H&E-like in range."""
    import numpy as np
    import torch.nn.functional as F

    out = np.empty((n, size, size, 3), np.uint8)
    for a in range(0, n, block):
        m = min(block, n - a)
        base = torch.rand(m, 3, 8, 8, generator=gen, device=gen.device)
        img = F.interpolate(base, size=(size, size), mode="bilinear", align_corners=False) * 0.6 + 0.2
        img = img + 0.08 * torch.randn(m, 3, size, size, generator=gen, device=gen.device)
        out[a:a + m] = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return out


def first_grad(optimizer: torch.optim.Optimizer, params: dict) -> dict:
    """Each leaf's norm of the first step's gradient as the optimizer got it
    (weight decay added), from its state after that step: SGD's momentum
    buffer, or Adam's first moment over (1 - beta1)."""
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "momentum_buffer" in st:
                out[id(p)] = st["momentum_buffer"]
            elif "exp_avg" in st:
                out[id(p)] = st["exp_avg"] / (1.0 - group["betas"][0])
    return norms({name: out[id(p)] for name, p in params.items() if id(p) in out})


def follow_first_chunk(stage, chunk, n: int, params: dict, weights: dict, followed: int = 3) -> dict:
    """Run the first chunk through ``stage.step.run``: step 1 (eager), the
    program's first gradient read from its optimizer, steps 2..followed
    (the captured graph), each leaf's change read, then the rest of the
    chunk.  Returns the program's readings."""
    out = stage.step.run(chunk, 1)
    losses = [float(out["loss"][0])]
    grad = first_grad(stage.state.optimizer, params)
    out = stage.step.run(tuple(x[1:] for x in chunk), followed - 1)
    losses += [float(v) for v in out["loss"][:followed - 1]]
    update = norms({name: p.detach() - weights[name] for name, p in params.items()})
    stage.step.run(tuple(x[followed:] for x in chunk), n - followed)
    return {"loss": losses, "grad": grad, "update": update}


def finetune_state(stage, weights: dict):
    """The fine-tune and consistency stages' program state: TripletNet and
    head with the mix's optimizer (the CLIs' ``make_optimizer``) and its
    first ``modules`` tensors frozen, loaded with ``weights``.  Its modules
    are made on the stage's device."""
    from ssl_cr_histo_tpu_torch.cli.common import make_optimizer
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    tr = stage.traffic
    # the modules made on the card: ``weights`` replace their initial
    # values, which the host's CPU would take seconds to draw
    with torch.device(stage.device):
        state = init_finetune_state(
            stage.cfg["program_model"], tr["classes"], stage.device,
            lambda params: make_optimizer(tr["optimizer"], params, tr["lr"], tr["weight_decay"]),
            modules=tr["modules"])
    state.model.load_state_dict(prefixed(weights, "net"))
    state.head.load_state_dict(prefixed(weights, "head"))
    trained = {**named_params(state.model, "net"), **named_params(state.head, "head")}
    return state, {k: p for k, p in trained.items() if p.requires_grad}

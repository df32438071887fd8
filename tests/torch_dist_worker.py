"""One process of a data-parallel world of the port, on the CPU, for
tests/test_torch_distributed.py and tests/test_torch_distributed_cli.py.
It imports torch and the port, never jax.

    python tests/torch_dist_worker.py CASE RANK WORLD RENDEZVOUS_FILE IN OUT

joins a gloo world of WORLD processes through ``file://RENDEZVOUS_FILE``,
runs CASE on the inputs ``torch.load(IN)`` and saves its result to
``OUT.RANK``.

    python -m torch.distributed.run --standalone --nproc_per_node N tests/torch_dist_worker.py cli OUT \
        -- CLI ARGS [-- CLI ARGS ...]

runs ``ssl_cr_histo_tpu_torch.cli.<CLI>.main(ARGS)`` for each command in
turn in each process the launcher starts (the first CLI joins the world)
and saves, to ``OUT.<I>.<RANK>`` for the I-th command, the paths the
process opened for writing and what the CLI computed (``predict_all``'s
outputs, the heatmap maps).

The step functions (``finetune_steps``, ``consistency_steps``,
``pretrain_steps``) are also what the tests run in their own process, with
no world, as the one-process reference: both sides run the same code on the
same seeded inputs.  Their models run in float64 on the float32 views the
steps draw (cast on the way in, ``float64_views``): in float32 the first
convolution's weight gradient sums some 10^4 products whose BatchNorm
gradient factors cancel, and strays ~3e-4 of its largest entry from float64
by rounding alone, whatever the world (the finding of
test_pretrain_step_v2_matches_jax), which would hide a sharding fault of the
same size.  Each process uses one torch thread.
"""

from __future__ import annotations

import builtins
import contextlib
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer  # noqa: E402
from ssl_cr_histo_tpu_torch.models import resnet  # noqa: E402
from ssl_cr_histo_tpu_torch.parallel import distributed as D  # noqa: E402
from ssl_cr_histo_tpu_torch.parallel import steps as S  # noqa: E402
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state  # noqa: E402

CPU = torch.device("cpu")


@contextlib.contextmanager
def float64_views():
    """The steps' augmentations (drawn and cut to this process's rows as
    ever) hand the model float64 views."""
    names = ("augment_rsp_batch_v1", "augment_3view_batch", "transform_fix_batch")
    real = {n: getattr(S.aug_batch, n) for n in names}
    cast = lambda out: tuple(t.double() for t in out) if isinstance(out, tuple) else out.double()  # noqa: E731
    for n, fn in real.items():
        setattr(S.aug_batch, n, lambda *a, fn=fn, **k: cast(fn(*a, **k)))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(S.aug_batch, n, fn)


def _state_out(state) -> dict:
    """The state's tensors after the steps, and the last step's gradients."""
    head = state.classifier if hasattr(state, "classifier") else state.head
    return {
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "head": {k: v.clone() for k, v in head.state_dict().items()},
        "grads": {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None},
    }


def finetune_steps(inp: dict) -> dict:
    """Two fine-tune steps (Kather's head, SGD-Nesterov 0.05) on this process's rows of
    ``inp['images']`` (steps, B, S, S, 3) and ``inp['labels']``."""
    cfg = TASKS["kather"]
    torch.manual_seed(inp["seed"])
    state = init_finetune_state("resnet18", cfg.num_classes, CPU, lambda ps: make_optimizer("sgd", ps, 0.05))
    state.model.double()
    state.head.double()
    gen = torch.Generator().manual_seed(inp["seed"] + 1)
    metrics = []
    for imgs, labels in zip(inp["images"], inp["labels"]):
        with float64_views():
            m = S.finetune_step(state, torch.from_numpy(D.local_rows(imgs)), torch.from_numpy(D.local_rows(labels)),
                                gen, cfg.task, global_batch=len(imgs))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, **_state_out(state)}


def consistency_steps(inp: dict) -> dict:
    """Two consistency steps (Kather, NAug 7, the views drawn by the step)
    on this process's rows of the labeled ``inp['x_l']`` (steps, B, ...),
    ``inp['y_l']`` and the unlabeled ``inp['x_u']`` (steps, mu * B, ...)."""
    cfg = TASKS["kather"]
    torch.manual_seed(inp["seed"])
    state = init_finetune_state("resnet18", cfg.num_classes, CPU, lambda ps: make_optimizer("sgd", ps, 0.05))
    state.model.double()
    state.head.double()
    teacher = init_teacher(state)
    gen = torch.Generator().manual_seed(inp["seed"] + 1)
    host_gen = torch.Generator().manual_seed(inp["host_seed"])
    metrics = []
    for x_l, y_l, x_u in zip(inp["x_l"], inp["y_l"], inp["x_u"]):
        with float64_views():
            m = S.consistency_step(state, teacher, torch.from_numpy(D.local_rows(x_l)),
                                   torch.from_numpy(D.local_rows(y_l)), torch.from_numpy(D.local_rows(x_u)), gen,
                                   cfg.task, n_aug=7, host_gen=host_gen, global_batch=len(x_l))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, **_state_out(state)}


def pretrain_steps(inp: dict, remat: bool = False) -> dict:
    """One pretrain step (v1 fused pool; its plain version on the CPU) on
    this process's rows of ``inp['tiles']`` (B, 3, S, S, 3), the orderings
    and draws drawn by the step."""
    torch.manual_seed(inp["seed"])
    state = init_triplet_state("resnet18", CPU, remat=remat)
    state.model.double()
    state.classifier.double()
    gen = torch.Generator().manual_seed(inp["seed"] + 1)
    with float64_views():
        m = S.pretrain_step(state, torch.from_numpy(D.local_rows(inp["tiles"])), gen,
                            global_batch=len(inp["tiles"]), return_feats=True)
    return {"metrics": {k: float(m[k]) for k in ("loss", "acc")}, "feats": m["feats"], "labels": m["labels"],
            **_state_out(state)}


def _primitives(inp: dict, out_dir: str) -> dict:
    """put_sharded / fetch_global round trips, the bucketed collectives, an
    indivisible batch, and the primary-only writes under a real rank."""
    from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
    from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
    from ssl_cr_histo_tpu_torch.train.loop import BestTracker, CsvLogger

    rank = D.process_index()
    res = {"rank": rank, "count": D.process_count(), "primary": D.is_primary(), "rows": rows_for_batch(8)}
    x = inp["batch"]
    local = D.put_sharded(x, CPU)
    res["local"] = local
    res["gathered"] = D.fetch_global(local)
    res["gathered_bool"] = D.fetch_global(local > 10)
    res["gathered_float"] = D.fetch_global(local.double() / 3)
    mean, ones = torch.full((3,), float(rank + 1)), torch.ones(2, dtype=torch.float64) * (rank + 1)
    D.all_reduce_mean_([mean, ones])
    res["means"] = (mean, ones)
    b = torch.full((4,), float(rank))
    D.broadcast_([b])
    res["broadcast"] = b
    try:
        rows_for_batch(7)
    except ValueError as e:
        res["indivisible"] = str(e)
    log = CsvLogger(os.path.join(out_dir, "log.csv"), "a,b")
    log.append(rank, 2.0)
    torch.manual_seed(0)
    state = init_triplet_state("resnet18", CPU)
    save_checkpoint(os.path.join(out_dir, "ckpt.pth"), state, {"rank": rank})
    # the barrier inside save_checkpoint: every process sees the file
    res["ckpt_seen"] = torch.load(os.path.join(out_dir, "ckpt.pth"), weights_only=False)["meta"]
    best = BestTracker(out_dir)
    res["best_saved"] = best.update(1.0 + rank, 1, state, {"rank": rank})
    return res


def global_bn(inp: dict) -> dict:
    """``GlobalBatchNorm2d`` in train mode on this process's rows of the
    global batch ``inp['x']``, in each layout (``contiguous``: NCHW,
    ``channels_last``), the backward fed this process's rows of
    ``inp['dy']``: {layout: its output, running statistics and batch
    count, input gradient, and the layouts of the output and the
    gradient}."""
    out = {}
    for layout, fmt in (("contiguous", torch.contiguous_format), ("channels_last", torch.channels_last)):
        bn = resnet.GlobalBatchNorm2d(inp["x"].shape[1]).double()
        x = D.local_rows(inp["x"]).contiguous(memory_format=fmt).requires_grad_()
        y = bn(x)
        y.backward(D.local_rows(inp["dy"]).contiguous(memory_format=fmt))
        out[layout] = {"y": y.detach(), "running_mean": bn.running_mean, "running_var": bn.running_var,
                       "num_batches_tracked": bn.num_batches_tracked, "dx": x.grad,
                       "y_layout": resnet.layout_name(y), "dx_layout": resnet.layout_name(x.grad)}
    return out


def bundle2(inp: dict) -> dict:
    """Everything test_torch_distributed.py runs on two processes."""
    return {
        "primitives": _primitives(inp, inp["out_dir"]),
        "global_bn": global_bn(inp["global_bn"]),
        "finetune": finetune_steps(inp["finetune"]),
        "consistency": consistency_steps(inp["consistency"]),
        "pretrain": pretrain_steps(inp["pretrain"]),
        "pretrain_remat": pretrain_steps(inp["pretrain"], remat=True),
    }


def _pretrain_f64(inp: dict) -> dict:
    """One float64 pretrain step from the JAX weights on this process's
    rows, with the global batch's injected draws: the step's augmentation
    computes its float32 views (returned, for the comparison with the JAX
    views) and hands the model its rows of the JAX views ``inp['x_jax']``
    in float64, as test_pretrain_step_v2_matches_jax does (at 32^2 layer4
    is 1x1, and its BatchNorm over a handful of values per channel turns
    the views' 1e-5 float32 gap into gradient gaps above the bounds); and
    each BatchNorm's global count."""
    torch.manual_seed(0)
    state = init_triplet_state("resnet18", CPU, lr=0.01, weight_decay=1e-4)
    state.model.load_state_dict(inp["sd"])
    state.classifier.load_state_dict(inp["head_sd"])
    state.model.double()
    state.classifier.double()
    views, counts = [], {}
    augment = S.aug_batch.augment_rsp_batch_v1
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: counts.__setitem__(
        name, i[0].shape[0] * i[0].shape[2] * i[0].shape[3] * D.process_count()))
        for name, m in state.model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    x_jax = torch.from_numpy(D.local_rows(inp["x_jax"]))
    S.aug_batch.augment_rsp_batch_v1 = lambda *a, **k: views.append(augment(*a, **k)) or x_jax
    try:
        m = S.pretrain_step(state, torch.from_numpy(D.local_rows(inp["tiles"])), torch.Generator().manual_seed(0),
                            labels=torch.from_numpy(D.local_rows(inp["labels"])), draws=inp["draws"],
                            global_batch=len(inp["tiles"]))
    finally:
        S.aug_batch.augment_rsp_batch_v1 = augment
        for h in hooks:
            h.remove()
    return {"loss": float(m["loss"]), "views": views[0], "counts": counts, **_state_out(state),
            "head_grads": {k: p.grad.clone() for k, p in state.classifier.named_parameters()}}


def pretrain4(inp: dict) -> dict:
    """The float64 pretrain step with global-batch BatchNorm, then the same
    step with each process's BatchNorm over its own rows (the negative
    control: ``nn.BatchNorm2d.forward`` in place of the global one)."""
    out = {"global_bn": _pretrain_f64(inp)}
    forward = resnet.GlobalBatchNorm2d.forward
    resnet.GlobalBatchNorm2d.forward = torch.nn.BatchNorm2d.forward
    try:
        out["per_rank_bn"] = _pretrain_f64(inp)
    finally:
        resnet.GlobalBatchNorm2d.forward = forward
    return out


CASES = {"bundle2": bundle2, "pretrain4": pretrain4}


@contextlib.contextmanager
def _recording_writes(paths: list):
    """Record every path opened for writing through ``builtins.open``
    (``np.save``, PIL, the CSV logger) or written by ``torch.save``."""
    real_open, real_save = builtins.open, torch.save

    def recording(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and isinstance(file, (str, os.PathLike)):
            paths.append(os.fspath(file))
        return real_open(file, mode, *a, **k)

    def saving(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):
            paths.append(os.fspath(f))
        return real_save(obj, f, *a, **k)

    builtins.open, torch.save = recording, saving
    try:
        yield
    finally:
        builtins.open, torch.save = real_open, real_save


def run_cli(out: str, cli: str, argv: list) -> dict:
    """``cli``'s main on ``argv``, recording its writes and what it
    computed."""
    import importlib

    from ssl_cr_histo_tpu_torch.cli import finetune

    mod = importlib.import_module(f"ssl_cr_histo_tpu_torch.cli.{cli}")
    outputs, writes = [], []
    predict_all = finetune.predict_all

    def recorded(*a, **k):
        outputs.append(predict_all(*a, **k))
        return outputs[-1]

    finetune.predict_all = recorded
    try:
        with _recording_writes(writes):
            ret = mod.main(argv)
    finally:
        finetune.predict_all = predict_all
    result = {"writes": writes, "outputs": outputs, "world": D.process_count()}
    if cli == "heatmap":
        result["maps"] = ret
    return result


def main(argv: list) -> None:
    torch.set_num_threads(1)
    if argv[0] == "cli":
        out, rest = argv[1], argv[2:]
        starts = [i for i, a in enumerate(rest) if a == "--"] + [len(rest)]
        for i, (a, e) in enumerate(zip(starts, starts[1:])):
            cli, *args = rest[a + 1:e]
            torch.save(run_cli(out, cli, args), f"{out}.{i}.{os.environ.get('RANK', '0')}")
        return
    case, rank, world, rendezvous, inp, out = argv
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=int(rank), world_size=int(world))
    try:
        result = CASES[case](torch.load(inp, weights_only=False))
        torch.save(result, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

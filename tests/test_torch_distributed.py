"""Data parallelism of the port on the CPU (``parallel.distributed``,
``parallel.mesh``, ``models.resnet.GlobalBatchNorm2d``): gloo worlds of 2
and 4 processes (``tests/torch_dist_worker.py``, one torch thread each,
rendezvous through a file under the test's temp dir) against one process
and against the JAX package's step on the global batch.

What must hold: N processes at a global batch B compute what one process
computes at B, as the JAX step does on an N-device mesh.  BatchNorm's
train-mode statistics span the global batch, the loss and the gradients are
global means, every random draw is the global batch's with each process
keeping its rows, and only the primary process writes."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.ops import pallas_photometric as PP
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train.checkpoint import export_torch_state_dict
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import randaugment as RA
from ssl_cr_histo_tpu_torch.parallel import distributed as D
from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params

import torch_dist_worker as W
from test_torch_pretrain_step import _head_sd, _jax_step_f64, _numpy_params
from torch_tmp import release


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_a_file():
    """One intra-op thread for the file's torch work (restored after): at
    the tests' sizes more threads buy nothing, and under the six-worker run
    every worker's spinning thread pool contends with the others' for the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64  # layer4 2x2, as tests/test_torch_pretrain_step.py takes it


def launch(case: str, world: int, inp: dict, tmp, timeout: float = 600) -> list:
    """Run ``case`` of the worker on ``world`` processes; each rank's result."""
    path, out, rendezvous = tmp / f"{case}.in", tmp / f"{case}.out", tmp / f"{case}.rendezvous"
    torch.save(inp, path)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"), case, str(r),
                               str(world), str(rendezvous), str(path), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    results = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    for r in range(world):  # each is up to ~0.8 GB of float64 states; the results stay in memory
        os.remove(f"{out}.{r}")
    return results


# --- two processes: the primitives, the writes, the steps against one ----------------


def _bundle_inputs(out_dir: str) -> dict:
    rng = np.random.default_rng(0)
    u8 = lambda *shape: rng.integers(0, 256, shape, dtype=np.uint8)  # noqa: E731
    return {
        "out_dir": out_dir,
        "batch": torch.arange(24).reshape(8, 3),
        "finetune": {"seed": 3, "images": u8(2, 4, IMG, IMG, 3), "labels": rng.integers(0, 9, (2, 4))},
        # host seed 0: both processes' rows own noise fields in both steps
        # (test_consistency_steps_match_one_process checks it)
        "consistency": {"seed": 5, "host_seed": 0, "x_l": u8(2, 2, IMG, IMG, 3), "y_l": rng.integers(0, 9, (2, 2)),
                        "x_u": u8(2, 4, IMG, IMG, 3)},
        "pretrain": {"seed": 7, "tiles": u8(4, 3, IMG, IMG, 3)},
        "global_bn": {"x": torch.from_numpy(rng.normal(1.0, 2.0, (8, 16, 6, 5))),
                      "dy": torch.from_numpy(rng.normal(size=(8, 16, 6, 5)))},
    }


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """Each rank's results of ``torch_dist_worker.bundle2`` on two
    processes, and its inputs."""
    tmp = tmp_path_factory.mktemp("dist2")
    os.makedirs(tmp / "writes")
    inp = _bundle_inputs(str(tmp / "writes"))
    yield launch("bundle2", 2, inp, tmp), inp
    release(tmp)


def _assert_state_close(got: dict, want: dict, what: str) -> None:
    """Parameters atol 1e-5 * max|p| per tensor, BN statistics rtol 1e-4 /
    atol 1e-6, gradients atol 1e-4 * max|g| per tensor (as the step
    parity tests against the JAX package bound them), batch counts equal."""
    for part in ("model", "head"):
        for k, w in want[part].items():
            g = got[part][k]
            if k.endswith("num_batches_tracked"):
                assert torch.equal(g, w), f"{what} {k}"
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=f"{what} {k}")
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * w.abs().max().item(),
                                           err_msg=f"{what} {part} {k}")
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), w.numpy(), rtol=0, atol=1e-4 * w.abs().max().item(),
                                   err_msg=f"{what} grad {k}")


def _assert_ranks_equal(results: list, key: str) -> None:
    """Every process holds the same state bit for bit after the steps: the
    collectives give each the same sums."""
    a, b = results[0][key], results[1][key]
    for part in ("model", "head", "grads"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{key}: {part} {k} differs across ranks"


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    """Without WORLD_SIZE / RANK, ``initialize`` joins nothing; one process
    is the primary, its rows are the whole batch, and the feed primitives
    are the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    D.initialize("cpu")
    assert not torch.distributed.is_initialized()
    assert D.process_count() == 1 and D.process_index() == 0 and D.is_primary()
    assert rows_for_batch(7) == (0, 7)
    x = np.arange(12).reshape(4, 3)
    t = D.put_sharded(x, "cpu")
    assert torch.equal(t, torch.from_numpy(x)) and D.fetch_global(t) is t
    g = torch.ones(3)
    D.all_reduce_mean_([g])
    D.broadcast_([g])
    assert torch.equal(g, torch.ones(3))


def test_put_sharded_and_fetch_global_round_trip(bundle):
    """Two processes: each keeps its contiguous half of a host-replicated
    batch; ``fetch_global`` gives both the whole batch bit for bit (int64,
    bool, float64); the bucketed mean and broadcast; ``rows_for_batch``."""
    results, inp = bundle
    x = inp["batch"]
    for r, res in enumerate(r["primitives"] for r in results):
        assert res["rank"] == r and res["count"] == 2 and res["primary"] == (r == 0)
        assert res["rows"] == (4 * r, 4 * r + 4)
        assert torch.equal(res["local"], x[4 * r: 4 * r + 4])
        assert torch.equal(res["gathered"], x)
        assert torch.equal(res["gathered_bool"], x > 10) and res["gathered_bool"].dtype == torch.bool
        assert torch.equal(res["gathered_float"], x.double() / 3)
        mean, ones = res["means"]
        assert torch.equal(mean, torch.full((3,), 1.5)) and torch.equal(ones, torch.full((2,), 1.5, dtype=torch.float64))
        assert torch.equal(res["broadcast"], torch.zeros(4))


def test_rows_for_batch_raises_on_an_indivisible_batch(bundle):
    """A global batch the world does not divide raises ValueError with the
    JAX package's wording (``mesh.py:52-61``), on every process."""
    for res in (r["primitives"] for r in bundle[0]):
        assert res["indivisible"].startswith("batch_size=7 is not divisible by the 2-device data axis")
        assert "pad_batches" in res["indivisible"]


def test_only_the_primary_writes(bundle):
    """Under a real rank 1: the CSV holds the header and rank 0's row only;
    the checkpoint is rank 0's and both processes read it after
    ``save_checkpoint`` returns (its barrier); ``best.pth`` is rank 0's
    (mirrors tests/test_distributed.py:17-98)."""
    results, inp = bundle
    out = inp["out_dir"]
    with open(os.path.join(out, "log.csv")) as f:
        assert f.read().splitlines() == ["a,b", "0,2.000000"]
    for res in (r["primitives"] for r in results):
        assert res["ckpt_seen"] == {"rank": 0}
        assert res["best_saved"]
    assert torch.load(os.path.join(out, "best.pth"), weights_only=False)["meta"]["rank"] == 0
    assert sorted(f for f in os.listdir(out)) == ["best.pth", "ckpt.pth", "log.csv"]


def test_finetune_steps_match_one_process(bundle):
    """Two fine-tune steps (SGD, the 3-view stack drawn by the step, the
    model in float64: see tests/torch_dist_worker.py) on two
    processes against one process at the same global batch of 4: the
    losses and accuracies (rtol 1e-5), then the parameters, BN statistics
    and gradients (``_assert_state_close``); both processes hold the same
    state bit for bit."""
    results, inp = bundle
    assert not torch.distributed.is_initialized()
    want = W.finetune_steps(inp["finetune"])
    _assert_ranks_equal(results, "finetune")
    got = results[0]["finetune"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    _assert_state_close(got, want, "finetune")


def test_consistency_steps_match_one_process(bundle):
    """Two consistency steps (Kather, NAug 7, fused, every view drawn by the
    step) on two processes, one labeled and two unlabeled images each,
    against one process at 2 + 4: losses and metric (rtol 1e-5), the
    student's state (``_assert_state_close``).  The draws of the chosen
    seeds give noise fields to both processes' rows, so the kept fields
    are each process's own."""
    results, inp = bundle
    case = inp["consistency"]
    gen, host = torch.Generator().manual_seed(case["seed"] + 1), torch.Generator().manual_seed(case["host_seed"])
    for x_u in case["x_u"]:
        d = TB.draw_transform_fix(gen, len(x_u), IMG, 7, host_gen=host)
        owners = (d["ops"] == RA.NOISE).sum(1)
        assert owners[:2].sum() > 0 and owners[2:].sum() > 0
        TB.draw_3view(gen, 2, IMG)
    want = W.consistency_steps(case)
    _assert_ranks_equal(results, "consistency")
    got = results[0]["consistency"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    _assert_state_close(got, want, "consistency")


def test_pretrain_step_matches_one_process(bundle):
    """A pretrain step (v1 fused pool, the orderings, warps, params and
    seeds drawn by the step) on two processes against one: the gathered
    orderings equal (the global batch's draw), the gathered features within
    1e-5 of the largest, the loss and accuracy, the state."""
    results, inp = bundle
    want = W.pretrain_steps(inp["pretrain"])
    _assert_ranks_equal(results, "pretrain")
    got = results[0]["pretrain"]
    assert torch.equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["feats"].numpy(), want["feats"].numpy(), rtol=0,
                               atol=1e-5 * want["feats"].abs().max().item())
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    _assert_state_close(got, want, "pretrain")


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_global_batchnorm_on_two_processes(bundle, layout):
    """``GlobalBatchNorm2d`` on two processes of four rows each, float64,
    in NCHW and in channels-last: the output and the input gradient,
    gathered in rank order, and the running statistics against
    ``nn.BatchNorm2d`` on the global batch in one process (within 1e-12 of
    the largest entry; the batch count equal), the output and gradient
    in the input's layout, and the channels-last case equal to the NCHW
    one within the same bound."""
    results, inp = bundle
    case = inp["global_bn"]
    bn = torch.nn.BatchNorm2d(16).double()
    x = case["x"].clone().requires_grad_()
    y = bn(x)
    y.backward(case["dy"])
    got = [r["global_bn"][layout] for r in results]
    close = lambda a, b, what: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), b.numpy(), rtol=0, atol=1e-12 * b.abs().max().item(), err_msg=f"{layout} {what}")
    close(torch.cat([g["y"] for g in got]), y.detach(), "output")
    close(torch.cat([g["dx"] for g in got]), x.grad, "input gradient")
    for g in got:
        for k in ("running_mean", "running_var"):
            close(g[k], getattr(bn, k), k)
        assert torch.equal(g["num_batches_tracked"], bn.num_batches_tracked)
        assert g["y_layout"] == g["dx_layout"] == layout
    for r in results:
        want, cl = r["global_bn"]["contiguous"], r["global_bn"]["channels_last"]
        for k in ("y", "dx", "running_mean", "running_var"):
            close(cl[k], want[k], f"{k} against NCHW")


def test_remat_under_two_processes_leaves_the_state_of_the_plain_step(bundle):
    """``--remat`` on two processes: each block's recomputation issues its
    BatchNorm all-reduces again, in the same order on every process, and
    the step leaves what the step without it leaves: the loss equal, the
    gradients within 1e-6, the BN statistics and counts equal
    (test_torch_flags.py's bounds in one process)."""
    for res in bundle[0]:
        remat, plain = res["pretrain_remat"], res["pretrain"]
        assert remat["metrics"]["loss"] == plain["metrics"]["loss"]
        for k, g in plain["grads"].items():
            np.testing.assert_allclose(remat["grads"][k].numpy(), g.numpy(), rtol=0, atol=1e-6, err_msg=k)
        for k, v in plain["model"].items():
            if "running" in k or "num_batches" in k:
                assert torch.equal(remat["model"][k], v), k


# --- four processes against the JAX package ---------------------------------------


B4, IMG4 = 8, 32


def _jax_views(data):
    """The JAX package's augmentation of the global batch on the injected
    draws (tests/test_torch_pretrain_step.py::_jax_augment at B4, IMG4)."""
    perm = JS.RSP_PERMUTATIONS[data["labels"]]
    tiles = np.take_along_axis(data["tiles"], perm[:, :, None, None, None], axis=1)
    imgs = JB.to_float(jnp.asarray(tiles.reshape(B4 * 3, IMG4, IMG4, 3).transpose(0, 3, 1, 2)))
    warped = jax.vmap(lambda im, m: JG.warp_affine_mxu_planar(im, m, pad_mode="reflect101"))(
        imgs, jnp.asarray(data["geo"]))
    out = JB._clip01(PP.pretrain_photometric_pallas(
        warped, jax.random.PRNGKey(0), interpret=True, noise=jnp.asarray(data["noise"]),
        params=jnp.asarray(data["params"]), planar_io=True))
    return JB.normalize_batch(out.reshape(B4, 3, 3, IMG4, IMG4), channel_axis=2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """flax weights from a seed, a global batch of 8 triplets of 32^2 with
    orderings and the v1 pool's draws made with numpy (the fused pool's
    noise comes from the kernel's Philox stream, which no JAX key draws, so
    the draws are injected into both packages, as
    test_pretrain_step_matches_jax injects them); the JAX float64 step on
    the global batch, and each rank's results of ``pretrain4``."""
    jm, jc = JTripletNet("resnet18"), JClassifier(num_classes=6)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dummy = jnp.zeros((1, IMG4, IMG4, 3), jnp.float32)
    v = jm.init(k1, dummy, dummy, dummy, train=False)
    params = {"model": v["params"], "head": jc.init(k2, jnp.zeros((1, 768)))["params"]}
    stats = v["batch_stats"]
    rng = np.random.default_rng(4)
    n = B4 * 3
    data = {
        "tiles": rng.integers(0, 256, (B4, 3, IMG4, IMG4, 3), dtype=np.uint8),
        "labels": rng.integers(0, 6, B4).astype(np.int32),
        "geo": TF.draw_pretrain_geo_matrices(torch.Generator().manual_seed(3), n, IMG4).numpy(),
        "params": _numpy_params(rng, n),
        "noise": rng.normal(size=(n, 3, IMG4, IMG4)).astype(np.float32),
    }
    x_jax = _jax_views(data)
    want = _jax_step_f64("resnet18", params, stats, x_jax, data["labels"])
    sd, head_sd = from_jax_params(jax.device_get(params["model"]), jax.device_get(stats),
                                  jax.device_get(params["head"]))
    inp = {"sd": sd, "head_sd": head_sd, "tiles": data["tiles"], "labels": data["labels"],
           "x_jax": np.asarray(x_jax, np.float64),
           "draws": {k: torch.from_numpy(data[k]) for k in ("geo", "params", "noise")}}
    tmp = tmp_path_factory.mktemp("dist4")
    yield launch("pretrain4", 4, inp, tmp), x_jax, want, params, stats
    release(tmp)


def _misses(res: dict, want, params, stats) -> list:
    """The names of what ``res`` (rank 0's step) misses against the JAX
    float64 step, with test_pretrain_step_matches_jax's tolerances: loss
    rtol 1e-5; gradients atol 1e-4 * max|g| per tensor; post-step params
    rtol 1e-5 / atol 1e-6; BN statistics rtol 1e-4 / atol 1e-6 after
    removing torch's unbiased n / (n - 1) factor over the global n."""
    jloss, grads, jparams, jstats = want
    bad = [] if np.allclose(res["loss"], float(jloss), rtol=1e-5, atol=0) else ["loss"]
    want_g = export_torch_state_dict(grads["model"], {})
    assert set(res["grads"]) == set(want_g)
    for k, w in want_g.items():
        if not np.allclose(res["grads"][k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max()):
            bad.append(f"grad {k}")
    for k, w in _head_sd(grads["head"]).items():
        if not np.allclose(res["head_grads"][k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max()):
            bad.append(f"grad {k}")
    for k, w in export_torch_state_dict(jparams["model"], {}).items():
        if not np.allclose(res["model"][k].numpy(), w, rtol=1e-5, atol=1e-6):
            bad.append(f"param {k}")
    for k, w in _head_sd(jparams["head"]).items():
        if not np.allclose(res["head"][k].numpy(), w, rtol=1e-5, atol=1e-6):
            bad.append(f"param {k}")
    want_s = export_torch_state_dict(jax.device_get(params["model"]), jstats)
    start = export_torch_state_dict(jax.device_get(params["model"]), jax.device_get(stats))
    for k, v in res["model"].items():
        if k.endswith("running_mean") and not np.allclose(v.numpy(), want_s[k], rtol=1e-4, atol=1e-6):
            bad.append(k)
        elif k.endswith("running_var"):
            n = res["counts"][k[: -len(".running_var")]]
            base = 0.9 * start[k]
            if not np.allclose(v.numpy() - base, n / (n - 1) * (want_s[k] - base), rtol=1e-4, atol=1e-6):
                bad.append(k)
    return bad


def test_four_process_pretrain_step_matches_jax(four_ranks):
    """Four processes of two triplets each, float64, BatchNorm over the
    global batch: each rank's float32 views (its augmentation on the
    global batch's draws) are its rows of the JAX views (atol 1e-5); the
    model half, on its rows of the JAX views (``torch_dist_worker.
    _pretrain_f64``), leaves every rank the same state, and rank 0's loss,
    gradients, parameters and BN statistics are the JAX package's float64
    step on the global batch of 8 (``_misses``)."""
    results, x_jax, want, params, stats = four_ranks
    views = torch.cat([r["global_bn"]["views"] for r in results])
    np.testing.assert_allclose(views.numpy(), np.asarray(x_jax), rtol=0, atol=1e-5)
    for r in results[1:]:
        assert r["global_bn"]["loss"] == results[0]["global_bn"]["loss"]
        for part in ("model", "grads", "head"):
            for k, v in results[0]["global_bn"][part].items():
                assert torch.equal(r["global_bn"][part][k], v), f"{part} {k}"
    assert _misses(results[0]["global_bn"], want, params, stats) == []


def test_per_rank_batchnorm_misses_the_jax_step(four_ranks):
    """The negative control: the same four processes with each
    BatchNorm's statistics over its own two triplets (``nn.BatchNorm2d``'s
    forward) miss the JAX step's loss, gradients and BN statistics."""
    results, _, want, params, stats = four_ranks
    bad = _misses(results[0]["per_rank_bn"], want, params, stats)
    assert "loss" in bad
    assert any(b.startswith("grad") for b in bad) and any(b.endswith("running_var") for b in bad)


# --- the port's sources ------------------------------------------------------------


def test_port_imports_no_jax_and_wraps_no_model():
    """No file of the port (``parallel/`` included) or ``chip_smoke.py``
    imports jax or the JAX package, and none names
    ``DistributedDataParallel`` or ``SyncBatchNorm``: the steps reduce the
    gradients themselves and BatchNorm is ``GlobalBatchNorm2d``."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ssl_cr_histo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert any(f.endswith(os.path.join("parallel", "distributed.py")) for f in files)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "flax", "ssl_cr_histo_tpu"}, path
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not names & {"DistributedDataParallel", "SyncBatchNorm"}, path


# --- the draws: a shard's views are the global batch's rows -------------------------


def _views(policy, gen_seed, x, start=0, stop=None, shard=None):
    """``policy``'s views of rows [start, stop) of ``x`` (each triplet
    ordered by its row's index mod 6) from freshly seeded generators."""
    gen, host = torch.Generator().manual_seed(gen_seed), torch.Generator().manual_seed(gen_seed + 1)
    order = (torch.arange(len(x)) % 6)[start:stop]
    x = x[start:stop]
    if policy.startswith("rsp_v1"):
        return TB.augment_rsp_batch_v1(gen, x, mode=policy.split("_")[-1], order=order, host_gen=host, shard=shard)
    if policy.startswith("rsp_v2"):
        return TB.augment_rsp_batch_v2(host, x, mode=policy.split("_")[-1], order=order, shard=shard)
    if policy == "3view":
        return TB.augment_3view_batch(gen, x, shard=shard)
    return torch.cat(TB.transform_fix_batch(gen, x, 7, mode=policy.split("_")[-1], host_gen=host, shard=shard), 1)


@pytest.mark.parametrize("policy", ["rsp_v1_fused", "rsp_v1_exact", "rsp_v2_fused", "rsp_v2_masked", "3view",
                                    "fix_fused", "fix_fast", "fix_masked", "fix_exact"])
def test_each_shard_draws_the_global_batchs_rows(policy):
    """Every augmentation entry point with ``shard`` = (offset, total) on a
    process's rows gives the rows of its output on the whole batch, bit for
    bit, for each of two halves and of four quarters, and leaves the
    generators where the whole batch leaves them: the draws are the global
    batch's, cut to the rows (the fused v1 pool's Philox noise at counter
    tile0 + n, its seeds and warps included)."""
    rng = np.random.default_rng(9)
    shape = (4, 3, 32, 32, 3) if policy.startswith("rsp") else (4, 32, 32, 3)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    whole = _views(policy, 11, x)
    for parts in (2, 4):
        rows = len(x) // parts
        for r in range(parts):
            got = _views(policy, 11, x, r * rows, (r + 1) * rows, shard=(r * rows, len(x)))
            assert torch.equal(got, whole[r * rows:(r + 1) * rows]), (parts, r)

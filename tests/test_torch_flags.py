"""The port's ``--remat`` and ``--reference_exact`` on the CPU: a step with
the backbone's blocks recomputed in the backward pass leaves the loss, the
gradients and the BatchNorm running statistics as the step without it does;
the strict-parity preset is the JAX package's table without its
``photometric`` entry, and each stage CLI applies it over explicit flags.
Float32 (and bf16 autocast), inputs made from seeds; torch on one intra-op
thread."""

import contextlib

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu.cli import common as JC
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.cli import consistency, finetune, heatmap, pretrain
from ssl_cr_histo_tpu_torch.models import resnet
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(model_name, remat, joint_encode, bf16):
    """One pretrain step from seed 0's weights on seeded 32^2 triplets:
    (loss, {name: grad}, state_dict of the TripletNet)."""
    torch.manual_seed(0)
    state = init_triplet_state(model_name, CPU, remat=remat)
    tiles = torch.randint(0, 256, (2, 3, 32, 32, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    m = S.pretrain_step(state, tiles, torch.Generator().manual_seed(2), labels=torch.tensor([1, 4]),
                        joint_encode=joint_encode, bf16=bf16)
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return float(m["loss"]), grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("model_name,joint_encode,bf16", [
    ("resnet18", True, False), ("resnet18", False, False), ("resnet50", True, False), ("resnet18", True, True)])
def test_remat_step_leaves_the_state_of_the_plain_step(model_name, joint_encode, bf16, monkeypatch):
    """A pretrain step with ``remat`` against the same step without it, in
    float32 (and under bf16 autocast, which the recomputation must see
    too): the loss equal, each gradient within 1e-6, every BatchNorm's
    running mean and variance equal and ``num_batches_tracked`` 1 (the
    recomputation runs each block's BatchNorms in train mode again; 3 with
    one backbone pass per view).  Each block of the backbone is
    recomputed: as many checkpointed calls as blocks and passes."""
    plain = _step(model_name, False, joint_encode, bf16)
    calls = []
    real = resnet.checkpoint
    monkeypatch.setattr(resnet, "checkpoint", lambda fn, *a, **k: calls.append(fn) or real(fn, *a, **k))
    remat = _step(model_name, True, joint_encode, bf16)
    blocks = 8 if model_name == "resnet18" else 16
    assert len(calls) == blocks * (1 if joint_encode else 3)
    assert remat[0] == plain[0]
    for k, g in plain[1].items():
        np.testing.assert_allclose(remat[1][k].numpy(), g.numpy(), rtol=0, atol=1e-6, err_msg=k)
    for k, v in plain[2].items():
        assert torch.equal(remat[2][k], v), k
    tracked = plain[2]["model.layer1.0.bn1.num_batches_tracked"]
    assert int(tracked) == (1 if joint_encode else 3)


def test_remat_keeps_bn_statistics_where_a_plain_checkpoint_does_not(monkeypatch):
    """The BatchNorm trap: without putting the statistics back, the
    recomputation would update them a second time (the test above fails on
    such a wrapper); in eval mode or without grad no block is recomputed."""
    monkeypatch.setattr(resnet, "_keep_bn_statistics", lambda block: contextlib.nullcontext())
    plain, naive = _step("resnet18", False, True, False), _step("resnet18", True, True, False)
    assert int(naive[2]["model.layer1.0.bn1.num_batches_tracked"]) == 2
    assert not torch.equal(naive[2]["model.layer1.0.bn1.running_mean"], plain[2]["model.layer1.0.bn1.running_mean"])
    calls = []
    monkeypatch.setattr(resnet, "checkpoint", lambda *a, **k: calls.append(1))
    net = resnet.ResNet18(remat=True)
    with torch.no_grad():
        net(torch.rand(2, 3, 32, 32))
    net.eval()(torch.rand(2, 3, 32, 32))
    assert not calls


def test_reference_exact_preset_is_the_jax_table_without_photometric():
    """The port's preset equals the JAX package's REFERENCE_EXACT_PRESET
    with its ``photometric`` entry dropped (the port has no such flag), and
    every key is a flag of the CLIs it applies to."""
    want = {stage: {k: v for k, v in table.items() if k != "photometric"}
            for stage, table in JC.REFERENCE_EXACT_PRESET.items()}
    assert TC.REFERENCE_EXACT_PRESET == want
    assert "photometric" in JC.REFERENCE_EXACT_PRESET["common"]
    parsed = {"pretrain": pretrain.parse_args(["--train_image_pth", "x"]),
              "finetune": finetune.parse_args(["--task", "kather"]),
              "consistency": consistency.parse_args(["--task", "kather"]),
              "heatmap": heatmap.parse_args(["--test_image_pth", "x", "--test_mask_pth", "x", "--probs_map_path",
                                             "x", "--finetune_ckpt", "x"])}
    for stage, args in parsed.items():
        keys = {**TC.REFERENCE_EXACT_PRESET["common"], **TC.REFERENCE_EXACT_PRESET.get(stage, {})}
        assert all(hasattr(args, k) for k in keys), stage


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli,argv,want", [
    (pretrain, ["--train_image_pth", "x", "--aug_mode", "fused", "--bf16", "--joint_encode"],
     {"bf16": False, "aug_mode": "exact", "joint_encode": False, "expand_orderings": True}),
    (finetune, ["--task", "kather", "--train_path", "x", "--aug_mode", "masked", "--bf16"],
     {"bf16": False, "aug_mode": "exact", "with_replacement": True}),
    (consistency, ["--task", "kather", "--train_path", "x", "--finetune_ckpt", "x", "--aug_mode", "fast"],
     {"bf16": False, "aug_mode": "exact", "with_replacement": True}),
    (heatmap, ["--test_image_pth", "x", "--test_mask_pth", "x", "--probs_map_path", "x", "--finetune_ckpt", "x",
               "--bf16"], {"bf16": False, "aug_mode": "exact"}),
])
def test_each_cli_applies_the_preset_over_explicit_flags(cli, argv, want, monkeypatch):
    """Each stage CLI's main resolves ``--reference_exact`` straight after
    parsing, before it reads a flag, overriding flags given explicitly;
    without it the explicit flags stand."""
    seen = []

    def stop(args):
        seen.append(args)
        raise _Stop

    monkeypatch.setattr(cli, "resolve_device", stop)
    for extra in (["--reference_exact"], []):
        with pytest.raises(_Stop):
            cli.main(argv + extra)
    strict, free = seen
    assert {k: getattr(strict, k) for k in want} == want
    assert free.bf16 is True and free.aug_mode == (argv[argv.index("--aug_mode") + 1] if "--aug_mode" in argv
                                                   else "fused")

"""UNI2-h's ViT backbone (``ssl_cr_histo_tpu_torch/models/vit.py``) against
the plain functional forward in ``tests/torch_vit_reference.py``, on seeded
weights, on the CPU.

The JAX package has no ViT, so the reference is a plain float64 torch
forward (attention written out as softmax(QK^T / sqrt(d)) V).  The tiny
shape keeps every kind of part: 56^2 images at patch 14 (16 patches), one
class and 8 register tokens, 2 blocks of width 64 with 4 heads of 16,
packed SwiGLU 64 -> 2x128 -> 64, LayerScale; it is registered for the
test as the model ``vit_tiny`` (``vit.CONFIGS``, ``nets._FC_DIMS``).  The
published widths are built on the meta device, which allocates nothing.

Tests marked ``cuda`` run on the card (the flash backend pinned, and its
refusal of what it cannot take); the file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vit.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_vit_reference as R
from ssl_cr_histo_tpu_torch.cli import common as C
from ssl_cr_histo_tpu_torch.data.pipeline import FeedCounters
from ssl_cr_histo_tpu_torch.models import TripletNet, nets, vit
from ssl_cr_histo_tpu_torch.ops import batch as aug_batch
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.train import freeze as tfreeze
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state
from torch_tmp import tmp_path  # noqa: F401  (a fixture)

TINY = dict(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, reg_tokens=8,
            init_values=0.1)
TINY_FC = (128, 32, 16)
CPU = torch.device("cpu")
B, CLASSES, LR, WD = 2, 9, 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_a_file():
    """One intra-op thread for the file's torch work (restored after): at
    the tests' sizes more threads buy nothing, and under the six-worker run
    every worker's thread pool contends with the others' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(vit.CONFIGS, "vit_tiny", TINY)
    monkeypatch.setitem(nets._FC_DIMS, "vit_tiny", TINY_FC)
    return "vit_tiny"


@torch.no_grad()
def _randomise(module, seed):
    """Every parameter moved off its initial value by 0.05 of a seeded
    normal: LayerNorm's affine, the biases and LayerScale all act."""
    g = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return module


def _images(seed, n=B):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, 56, 56, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, CLASSES, n)))


def _state(name, remat=False, dtype=torch.float32):
    torch.manual_seed(0)
    state = init_finetune_state(name, CLASSES, CPU, lambda ps: C.make_optimizer("adam", ps, LR, WD), remat=remat)
    _randomise(state.model, 1)
    _randomise(state.head, 2)
    state.model.to(dtype)
    state.head.to(dtype)
    return state


# --- the forward --------------------------------------------------------------


def test_forward_matches_reference_float64(tiny):
    """The backbone in float64 against the reference in float64: the same
    equations in another association (F.layer_norm, SDPA's math backend
    scaling Q before QK^T), so they differ by rounding alone, ~1e-15 of
    features of size ~1; atol 1e-12 leaves that a thousandfold."""
    model = _randomise(vit.ViT(**vit.CONFIGS[tiny]), 3).double().train()
    x = torch.rand(3, 3, 56, 56, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    got = model(x)
    want = R.forward(dict(model.state_dict()), x, TINY)
    assert got.shape == (3, 64) and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert model.attention_calls == {"MATH": TINY["depth"]}


def test_forward_float32_and_bf16_against_float64():
    """In float32 the features stay within 1e-4 of the float64 reference
    (float32 rounds at ~6e-8 of each value; 2 blocks and the LayerNorms
    grow that to ~1e-6); under bfloat16 autocast they do not (bf16 rounds
    at ~4e-3), so the float32 bound tells the two apart.  The residual
    stream stays float32 under autocast: the features come out float32."""
    torch.manual_seed(0)
    model = _randomise(vit.ViT(**TINY), 3).train()
    x = torch.rand(3, 3, 56, 56, generator=torch.Generator().manual_seed(4))
    want = R.forward({k: v.double() for k, v in model.state_dict().items()}, x.double(), TINY)
    got = model(x)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        low = model(x)
    assert low.dtype == torch.float32
    assert (low.double() - want).abs().max() > 1e-4


def test_wrong_image_size_is_refused():
    with pytest.raises(ValueError, match="56\\^2 images"):
        vit.ViT(**TINY)(torch.zeros(1, 3, 64, 64))


def test_sdpa_backend_off_the_card():
    """The math backend wherever flash is not pinned: the CPU in any
    dtype."""
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        assert vit.sdpa_backend(torch.zeros(1, dtype=dtype)) == torch.nn.attention.SDPBackend.MATH


# --- one fine-tune step, remat, K steps ----------------------------------------


def _reference_step(state, views, labels):
    """The reference's loss and gradients of one fine-tune step on
    ``views`` (B, 3, C, H, W) float64 for the state's float64 weights: the
    backbone, the pair head on (e, e), three times, the 9-way head,
    cross-entropy over each view with its image's label."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in state.model.named_parameters()}
    h = {k: v.detach().clone().requires_grad_(True) for k, v in state.head.named_parameters()}
    b, v = views.shape[:2]
    x = aug_batch.normalize_batch(views.reshape(b * v, *views.shape[2:]), channel_axis=1)
    e = R.forward({k[len("model."):]: t for k, t in p.items() if k.startswith("model.")}, x, TINY)
    pair = torch.cat([e, e], -1)
    f = torch.relu(pair @ p["fc.0.weight"].T + p["fc.0.bias"]) @ p["fc.2.weight"].T + p["fc.2.bias"]
    logits = torch.cat([f, f, f], -1) @ h["classifier.0.weight"].T + h["classifier.0.bias"]
    loss = F.cross_entropy(logits, labels.repeat_interleave(v))
    grads = torch.autograd.grad(loss, list(p.values()) + list(h.values()))
    named = dict(zip([f"model.{k}" for k in p] + [f"head.{k}" for k in h], grads))
    start = {f"model.{k}": t.detach() for k, t in p.items()} | {f"head.{k}": t.detach() for k, t in h.items()}
    return loss.detach(), named, start


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_finetune_step_matches_reference(tiny, remat, monkeypatch):
    """One ``finetune_step`` (3-view stack, ``encode_single``, the head,
    cross-entropy, Adam with L2) of the float64 model against the reference
    on the same views, with ``remat`` and without.  The step takes its
    cross-entropy in float32 (``steps.cross_entropy``), so the loss and the
    logits' gradient carry float32 rounding (~6e-8 relative) into float64
    math: the loss rtol 1e-6, each gradient atol 1e-6 of its tensor's
    largest entry (6.5e-8 seen).  The update each parameter took: Adam's
    first step is lr * d / (|d| + eps) for d = g + wd * p, which near
    |d| ~ eps = 1e-8 magnifies d's rounding by up to 1 / (4 eps); held at
    atol 1e-3 * lr (1.9e-4 * lr seen, on entries with |d| ~ 1e-9)."""
    images, labels = _images(5)
    views = aug_batch.augment_3view_batch(torch.Generator().manual_seed(6), images).double()
    monkeypatch.setattr(S.aug_batch, "augment_3view_batch", lambda gen, x, d=None, shard=None: views)
    state = _state(tiny, remat=remat, dtype=torch.float64)
    want_loss, want_g, start = _reference_step(state, views, labels)
    out = S.finetune_step(state, images, labels, torch.Generator())
    assert state.step == 1
    torch.testing.assert_close(out["loss"].double(), want_loss, rtol=1e-6, atol=0)
    params = {f"model.{k}": q for k, q in state.model.named_parameters()}
    params |= {f"head.{k}": q for k, q in state.head.named_parameters()}
    assert sorted(params) == sorted(want_g)
    for k, q in params.items():
        g = want_g[k]
        torch.testing.assert_close(q.grad, g, rtol=0, atol=1e-6 * float(g.abs().max()), msg=k)
        d = g + WD * start[k]
        torch.testing.assert_close(q.detach() - start[k], -LR * d / (d.abs() + 1e-8), rtol=0, atol=1e-3 * LR,
                                   msg=k)


def test_remat_gives_the_same_gradients(tiny):
    """``remat`` recomputes each block in the backward pass; a block has no
    state and draws nothing, so the gradients and the updated weights are
    those without it, bit for bit."""
    images, labels = _images(7)
    runs = []
    for remat in (False, True):
        state = _state(tiny, remat=remat)
        S.finetune_step(state, images, labels, torch.Generator().manual_seed(8))
        runs.append({k: (p.detach().clone(), p.grad.clone()) for k, p in state.model.named_parameters()})
    for k, (p, g) in runs[0].items():
        assert torch.equal(g, runs[1][k][1]) and torch.equal(p, runs[1][k][0]), k


def _split(runner):
    """``runner`` as the card runs it, its body called eagerly instead of
    replayed: the first step eager, then the body and the epilogue."""
    runner.graphed = True
    runner._replay = lambda inputs: runner.body(*inputs)
    return runner


@pytest.mark.parametrize("split", [False, True], ids=["eager", "split"])
def test_k_steps_equal_eager_steps(tiny, split):
    """``make_finetune_multi_step`` at K = 2 over one chunk of two steps
    against two ``finetune_step`` calls on the same batches and generator:
    the metrics, the weights, Adam's moments and the generator bit for
    bit."""
    rows = [_images(9), _images(10)]
    runs = []
    for multi in (False, True):
        state, gen = _state(tiny), torch.Generator().manual_seed(11)
        if multi:
            runner = S.make_finetune_multi_step(state, gen, 2)
            out = (_split(runner) if split else runner).run(tuple(torch.stack(c) for c in zip(*rows)), 2)
            metrics = [{k: v[i] for k, v in out.items()} for i in range(2)]
        else:
            metrics = [S.finetune_step(state, x, y, gen) for x, y in rows]
        runs.append((metrics, state, gen.get_state()))
    (m0, s0, g0), (m1, s1, g1) = runs
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (k, p), q in zip(s0.model.named_parameters(), s1.model.parameters()):
        assert torch.equal(p, q), k
        sa, sb = s0.optimizer.state[p], s1.optimizer.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), k
    assert torch.equal(g0, g1) and s0.step == s1.step == 2


# --- the published widths -------------------------------------------------------


def test_uni2h_at_published_widths():
    """``make_backbone("uni2h")`` on the meta device: timm's names and
    shapes, in timm's parameter order, and 681.39 M parameters."""
    with torch.device("meta"):
        net = TripletNet("uni2h")
    named = dict(net.model.named_parameters())
    d = 1536
    want = {"cls_token": (1, 1, d), "reg_token": (1, 8, d), "pos_embed": (1, 256, d),
            "patch_embed.proj.weight": (d, 3, 14, 14), "patch_embed.proj.bias": (d,)}
    for i in range(24):
        pre = f"blocks.{i}."
        want |= {pre + "norm1.weight": (d,), pre + "norm1.bias": (d,), pre + "attn.qkv.weight": (3 * d, d),
                 pre + "attn.qkv.bias": (3 * d,), pre + "attn.proj.weight": (d, d), pre + "attn.proj.bias": (d,),
                 pre + "ls1.gamma": (d,), pre + "norm2.weight": (d,), pre + "norm2.bias": (d,),
                 pre + "mlp.fc1.weight": (8192, d), pre + "mlp.fc1.bias": (8192,),
                 pre + "mlp.fc2.weight": (d, 4096), pre + "mlp.fc2.bias": (d,), pre + "ls2.gamma": (d,)}
    want |= {"norm.weight": (d,), "norm.bias": (d,)}
    assert list(named) == list(want)
    assert {k: tuple(p.shape) for k, p in named.items()} == want
    assert sum(p.numel() for p in named.values()) == 681_394_176
    assert nets.feature_dim("uni2h") == 1152
    assert [tuple(m.weight.shape) for m in (net.fc[0], net.fc[2])] == [(768, 3072), (384, 768)]
    block = net.model.blocks[0]
    assert block.attn.num_heads == 24 and block.norm1.eps == 1e-6 and net.model.norm.eps == 1e-6


def test_freeze_operating_points_at_published_widths():
    """``train.freeze``'s ViT operating points (its docstring): 5 the patch
    embedding and the tokens, 19 through block 0, 343 the whole backbone;
    freezing the whole backbone leaves the pair head and the head alone to
    the optimizer."""
    with torch.device("meta"):
        state = init_finetune_state("uni2h", CLASSES, torch.device("meta"),
                                    lambda ps: C.make_optimizer("adam", ps, LR, WD), modules=343)
    order = [k.removeprefix("model.") for k in tfreeze.torch_param_order(state.model)]
    assert sorted(order[:5]) == ["cls_token", "patch_embed.proj.bias", "patch_embed.proj.weight", "pos_embed",
                                 "reg_token"]
    assert order[18] == "blocks.0.ls2.gamma" and order[19] == "blocks.1.norm1.weight"
    assert order[340] == "blocks.23.ls2.gamma" and order[341:] == [
        "norm.weight", "norm.bias", "fc.0.weight", "fc.0.bias", "fc.2.weight", "fc.2.bias"]
    trained = [p for g in state.optimizer.param_groups for p in g["params"]]
    names = {id(p): f"model.{k}" for k, p in state.model.named_parameters()}
    names |= {id(p): f"head.{k}" for k, p in state.head.named_parameters()}
    assert [names[id(p)] for p in trained] == ["model.fc.0.weight", "model.fc.0.bias", "model.fc.2.weight",
                                               "model.fc.2.bias", "head.classifier.0.weight",
                                               "head.classifier.0.bias"]


def test_model_flag_takes_uni2h():
    from ssl_cr_histo_tpu_torch.cli import consistency, finetune, pretrain
    from ssl_cr_histo_tpu_torch.tools import profile_step

    assert finetune.parse_args(["--model", "uni2h", "--task", "kather"]).model == "uni2h"
    assert consistency.parse_args(["--model", "uni2h", "--task", "kather"]).model == "uni2h"
    assert pretrain.parse_args(["--model", "uni2h", "--train_image_pth", "x"]).model == "uni2h"
    assert profile_step.parse_args(["--model", "uni2h", "--logdir", "x"]).model == "uni2h"
    with pytest.raises(SystemExit):
        profile_step.parse_args(["--model", "vit_huge", "--logdir", "x"])


# --- spans and counters ---------------------------------------------------------


def test_spans_and_counter_in_profile_step(monkeypatch, tmp_path, capsys):
    """``tools/profile_step.py --model uni2h`` (the tiny shape standing in
    for the published one) on the CPU at ``--multi_step 1``: the spans
    ``port.vit.attention`` and ``port.vit.mlp`` once a block a forward,
    and the attention calls by backend on the ``traced steps:`` line."""
    from ssl_cr_histo_tpu_torch.tools import profile_step

    monkeypatch.setitem(vit.CONFIGS, "uni2h", TINY)
    monkeypatch.setitem(nets._FC_DIMS, "uni2h", TINY_FC)
    out = profile_step.main(["--stage", "finetune", "--model", "uni2h", "--image_size", "56", "--batch_size",
                             "2", "--steps", "2", "--multi_step", "1", "--device", "cpu",
                             "--logdir", str(tmp_path)])
    spans = out["spans"]["spans"]
    assert spans["port.vit.attention"]["calls"] == spans["port.vit.mlp"]["calls"] == 2 * TINY["depth"]
    line = [t for t in capsys.readouterr().out.splitlines() if t.startswith("traced steps:")]
    assert line and "; attention calls math 4;" in line[0], line


def test_attention_line(tiny):
    """The epoch line's attention calls since the reader was made
    (``cli.common.StretchCounters``), none for a ResNet."""
    def stretch(net):
        step = S.StepGraph("t", dict, None, dict, lambda: None, 1, CPU)
        return C.StretchCounters(C.Feed(iter(()), FeedCounters(1, 1)), step, net)

    idle = "feed starved 0.000 s in 0 waits, read 0.000 s, pin 0.000 s; step 0 eager, 0 replays, 0 captures (0.000 s)"
    net = TripletNet(tiny)
    before = stretch(net)
    net.encode_single(torch.zeros(2, 3, 56, 56))
    assert before.line() == idle + "; attention calls math 2"
    assert stretch(net).line() == idle + "; attention calls math 0"
    assert "attention calls" not in stretch(TripletNet("resnet18")).line()


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_pinned_on_the_card(cuda):
    """Under bf16 autocast on the card every attention call runs on the
    flash backend, forward and backward, and the features stay within
    bf16's rounding (atol 0.05 on features of size ~1) of the float64
    reference on the CPU."""
    torch.manual_seed(0)
    model = _randomise(vit.ViT(**TINY), 3).train()
    x = torch.rand(4, 3, 56, 56, generator=torch.Generator().manual_seed(4))
    want = R.forward({k: v.double() for k, v in model.state_dict().items()}, x.double(), TINY)
    model.to(cuda)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = model(x.to(cuda))
    got.sum().backward()
    assert model.attention_calls == {"FLASH_ATTENTION": TINY["depth"]}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    torch.testing.assert_close(got.double().cpu(), want, rtol=0, atol=0.05)


@pytest.mark.cuda
def test_flash_refuses_loudly(cuda):
    """A head of 512 is beyond the flash backend: the pinned call raises
    instead of falling back to a backend that keeps the scores."""
    model = vit.ViT(img_size=28, patch_size=14, embed_dim=1024, depth=1, num_heads=2, mlp_ratio=2.0, reg_tokens=0,
                    init_values=0.1).to(cuda)
    with torch.autocast("cuda", dtype=torch.bfloat16), pytest.raises(RuntimeError):
        model(torch.rand(2, 3, 28, 28, device=cuda))

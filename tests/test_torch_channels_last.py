"""The ResNet trunk in the channels-last layout (``models/resnet.py``) on
the CPU, in float64: the same forward, running statistics, gradients and
state_dict as the NCHW trunk, up to the rounding of another summation
order.  On a card the layout is the rule (``resnet.apply_device_layout``,
applied where the states are made); here the tests lay the weights out by
hand, which takes the same path through the forward.  The card's own
cases (the states ``train.init`` makes, a bf16 step against the NCHW one)
are in tests/test_torch_cuda_kernels.py."""

import copy

import pytest
import torch

from ssl_cr_histo_tpu_torch.cli import common as C
from ssl_cr_histo_tpu_torch.data.pipeline import FeedCounters
from ssl_cr_histo_tpu_torch.models import TripletNet, resnet, vit
from ssl_cr_histo_tpu_torch.parallel.steps import StepGraph

IMG = 64
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the file's torch work (restored after), as
    every port test file takes it under the six-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= RTOL * scale, what


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_channels_last_trunk_matches_nchw(name, train, remat):
    """A trunk with channels-last weights and input against the same
    trunk in NCHW: forward output, running statistics and batch counts,
    every parameter's gradient within 1e-10 of the largest entry; the
    gradients in the parameters' layouts; each state_dict loading into the
    other layout's trunk unchanged, the loading trunk keeping its layout;
    the layout counter."""
    torch.manual_seed(0)
    nchw = resnet.make_backbone(name, remat).double().train(train)
    cl = copy.deepcopy(nchw).to(memory_format=torch.channels_last)
    x = torch.randn(4, 3, IMG, IMG, dtype=torch.float64)
    y, y_cl = nchw(x), cl(x.contiguous(memory_format=torch.channels_last))
    _close(y_cl, y, "forward")
    w = torch.randn_like(y)
    (y * w).sum().backward()
    (y_cl * w).sum().backward()
    params, params_cl = dict(nchw.named_parameters()), dict(cl.named_parameters())
    for k, p in params.items():
        g = params_cl[k].grad
        _close(g, p.grad, f"grad {k}")
        assert g.stride() == params_cl[k].stride(), k
    for k, b in nchw.named_buffers():
        b_cl = dict(cl.named_buffers())[k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(b_cl, b) and int(b) == int(train), k
        else:
            _close(b_cl, b, k)
    assert nchw.layouts == {"contiguous": 1} and cl.layouts == {"channels_last": 1}

    sd, sd_cl = nchw.state_dict(), cl.state_dict()
    assert [(k, v.shape) for k, v in sd.items()] == [(k, v.shape) for k, v in sd_cl.items()]
    for want, into_layout in ((sd_cl, torch.contiguous_format), (sd, torch.channels_last)):
        fresh = resnet.make_backbone(name).double().to(memory_format=into_layout)
        fresh.load_state_dict(want)
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, want[k]), k
            if v.dim() == 4:
                assert v.is_contiguous(memory_format=into_layout), k


def test_device_layout_leaves_the_cpu_and_the_vit_as_they_are():
    """``apply_device_layout`` lays out only trunks on a CUDA device: a CPU
    TripletNet stays NCHW, and a ViT is never touched (its patch
    embedding's convolution keeps its layout wherever it is)."""
    net = TripletNet("resnet18")
    before = {k: v.stride() for k, v in net.state_dict().items()}
    assert resnet.apply_device_layout(net) is net
    assert {k: v.stride() for k, v in net.state_dict().items()} == before
    tiny = vit.ViT(img_size=28, patch_size=14, embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, reg_tokens=1,
                   init_values=0.1)
    resnet.apply_device_layout(tiny)
    assert tiny.patch_embed.proj.weight.is_contiguous()
    assert "trunk forwards" not in _stretch(tiny).line()


# the epoch line of a feed and a step that have counted nothing
IDLE = "feed starved 0.000 s in 0 waits, read 0.000 s, pin 0.000 s; step 0 eager, 0 replays, 0 captures (0.000 s)"


def _stretch(*models) -> C.StretchCounters:
    """The epoch line's reader over ``models``, with an idle feed and step."""
    step = StepGraph("t", dict, None, dict, lambda: None, 1, torch.device("cpu"))
    return C.StretchCounters(C.Feed(iter(()), FeedCounters(1, 1)), step, *models)


def test_layout_line_counts_forwards_since_a_reading():
    """The epoch line's trunk forwards by layout since the reader was made,
    over a student and its teacher together; none counted as 0."""
    student = TripletNet("resnet18").eval()
    teacher = copy.deepcopy(student).to(memory_format=torch.channels_last)
    stretch = _stretch(student, teacher)
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        student.encode_single(x)
        student.forward_joint(torch.rand(1, 3, 3, 32, 32))
        teacher.encode_single(x)
    assert stretch.line() == IDLE + "; trunk forwards channels_last 1, contiguous 2"
    assert _stretch(student).line() == IDLE + "; trunk forwards contiguous 0"

"""Backbone families: a configuration names its family, and the reference
net, the seeded weights and the FLOP count follow it.

The ResNet family's numbers are frozen: each cell's FLOPs a step, each
configuration's seeded weights and the reference's first step at a tiny
size, taken on the CPU before the ResNet moved into its own module.  A toy
attention family, registered here and in no file of the benchmark, runs
through the shared code: a family is added by new files alone.

    python3 -m pytest port_bench/tests/test_port_bench_family.py -q
"""

import hashlib
import json
import math
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from port_bench import weights, yardstick
from port_bench.reference import nets, training
from port_bench.stages.common import seeded_images

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGE_MIX = {"pretrain": "rsp_pretrain", "finetune": "finetune", "consistency": "consistency"}
RSP_CLASSES = 6

FLOPS = {"pretrain.resnet18": 2670383628288, "pretrain.resnet50": 6096043671552,
         "cr.resnet18.camelyon16": 2756032839680, "finetune.resnet18.kather": 2044668248064}
# sha256 over each tensor's name, dtype and bytes, in the spec's order, of
# make_weights(param_spec(cfg, 6, 9), seed 0) on the CPU
WEIGHTS = {"resnet18": "bdc5f0223b7a066a873ef2d2dc99a33677a690cd3f4516bab4a363993d09161b",
           "resnet50": "88b1a73047d9492ee97d91b9ffb108deb448e1247c52f3639e8bd1f3b559f67a"}
# the reference's first step on 2 images of 32^2 (one thread): its loss, the
# sum of the leaves' gradient norms, and sha256 of the sorted (leaf, norm)
# pairs as JSON
READINGS = {
    "pretrain.resnet18": (1.9685189723968506, 1020.2302248829498,
                          "1c44375a80b213cf0983d257cd37ae9cc06eb7b1fbb8ff3a923cafc8be46f01f"),
    "pretrain.resnet50": (3.202181816101074, 34402.725190287405,
                          "5166f63a6cd06eca7de64eff1aa49188d3662b188d4cdeaf71cb8e53fecf692c"),
    "finetune.resnet18": (2.968876600265503, 793.6793031106542,
                          "4af692cd1cc4f00a2ebe28c478a13904fa7f19b4457bd8b076486b8b5e102771"),
    "finetune.resnet50": (2.7507107257843018, 22505.448004711885,
                          "660152da4a5d0e64f49d5d4fdc5b5fa755a8e08d4755d7ebec8d40b4fb428475"),
    "consistency.resnet18": (1.0498664379119873, 572.456629204646,
                             "d7d11249e487a6dd3889425a74bbfa2214ba5ce8b448a52b6370fc99e6d9b8c6"),
    "consistency.resnet50": (1.3128608465194702, 7868.579083727376,
                             "aec11efc524dfe0f754cdd0e58f45741403a15db547cd6ea8f4320c1a589a07c"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(kind, name):
    with open(os.path.join(ROOT, "port_bench", kind, f"{name}.json")) as f:
        return json.load(f)


def cell_flops(cfg, tr):
    """A step's FLOPs as the cell's driver counts them."""
    if tr["stage"] == "pretrain":
        return yardstick.pretrain_step_flops(cfg, tr["batch"], tr["tile"], RSP_CLASSES)
    if tr["stage"] == "finetune":
        return yardstick.finetune_step_flops(cfg, 3 * tr["batch"], tr["size"], tr["classes"])
    bu = tr["labeled"] * tr["mu"]
    return yardstick.consistency_step_flops(cfg, 3 * tr["labeled"] + bu, bu, tr["size"], tr["classes"])


def first_steps(stage, cfg, tr, steps=1, b=2, s=32, quant=None):
    """The reference's ``steps`` steps of ``stage`` on seeded images."""
    gen = torch.Generator().manual_seed(7)
    images = lambda n: torch.from_numpy(seeded_images(gen, steps * n, s))
    y = torch.arange(steps * b).reshape(steps, b) % tr.get("classes", RSP_CLASSES)
    if stage == "pretrain":
        spec = nets.param_spec(cfg, rsp_classes=RSP_CLASSES)
        w = weights.make_weights(spec, 0, "cpu")
        return spec, training.follow_pretrain(cfg, tr, spec, w, images(3 * b).reshape(steps, b, 3, s, s, 3), 1,
                                              steps, quant=quant)
    spec = nets.param_spec(cfg, head_classes=tr["classes"])
    w = weights.make_weights(spec, 0, "cpu")
    x_l = images(b).reshape(steps, b, s, s, 3)
    if stage == "finetune":
        return spec, training.follow_finetune(cfg, tr, spec, w, x_l, y, 1, steps, quant=quant)
    x_u = images(b * tr["mu"]).reshape(steps, b * tr["mu"], s, s, 3)
    return spec, training.follow_consistency(cfg, tr, spec, w, x_l, y, x_u, 1, 1, steps, quant=quant)


# ---------------------------------------------------------------------------
# The ResNet family, as it was
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_flops_per_step_frozen(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        w = next(w for w in json.load(f)["workloads"] if w["name"] == cell)
    assert cell_flops(load("configs", w["config"]), load("mixes", w["traffic"])) == FLOPS[cell]


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_seeded_weights_frozen(name):
    h = hashlib.sha256()
    for k, v in weights.make_weights(nets.param_spec(load("configs", name), 6, 9), 0, "cpu").items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[name]


@pytest.mark.parametrize("key", sorted(READINGS))
def test_reference_first_step_frozen(key):
    stage, name = key.split(".")
    _, out = first_steps(stage, load("configs", name), load("mixes", STAGE_MIX[stage]))
    grads = sorted(out["grad"].items())
    got = (out["loss"][0], sum(v for _, v in grads), hashlib.sha256(json.dumps(grads).encode()).hexdigest())
    assert got == READINGS[key]


def test_config_without_family_names_its_file():
    cfg = load("configs", "resnet18")
    del cfg["family"]
    with pytest.raises(ValueError, match="port_bench/configs/resnet18.json"):
        nets.param_spec(cfg)


# ---------------------------------------------------------------------------
# A toy attention family, in no file of the benchmark
# ---------------------------------------------------------------------------

TOY = {"name": "toy", "family": "toy", "img_size": 32, "patch": 8, "width": 32, "heads": 2, "mlp": 64,
       "pair_fc": [64, 32, 16], "rsp_hidden": 16}


def toy_spec(cfg):
    """Patch embedding, position embeddings on the patch tokens, a class
    token, one pre-LN block (attention, MLP, LayerScale), a final norm."""
    d, h, m = cfg["width"], cfg["mlp"], "net.model."
    tokens = (cfg["img_size"] // cfg["patch"]) ** 2
    ln = lambda n: [(f"{m}{n}.weight", (d,), "fill", 1.0), (f"{m}{n}.bias", (d,), "fill", 0.0)]
    lin = lambda n, dout, din: [(f"{m}{n}.weight", (dout, din), "linear"), (f"{m}{n}.bias", (dout,), "bias")]
    return ([(f"{m}patch_embed.proj.weight", (d, 3, cfg["patch"], cfg["patch"]), "conv"),
             (f"{m}patch_embed.proj.bias", (d,), "bias"),
             (f"{m}cls_token", (1, 1, d), "normal", 1e-6),
             (f"{m}pos_embed", (1, tokens, d), "normal", 0.02)]
            + ln("blocks.0.norm1") + lin("blocks.0.attn.qkv", 3 * d, d) + lin("blocks.0.attn.proj", d, d)
            + [(f"{m}blocks.0.ls1.gamma", (d,), "fill", 0.5)]
            + ln("blocks.0.norm2") + lin("blocks.0.mlp.fc1", h, d) + lin("blocks.0.mlp.fc2", d, h)
            + [(f"{m}blocks.0.ls2.gamma", (d,), "fill", 0.5)]
            + ln("norm"))


def toy_backbone(cfg, p, x, train, q):
    d, heads = cfg["width"], cfg["heads"]
    g = lambda n: p[f"net.model.{n}"]
    lin = lambda n, t: q(F.linear(q(t), q(g(f"{n}.weight")), g(f"{n}.bias")))
    ln = lambda n, t: q(F.layer_norm(t, (d,), g(f"{n}.weight"), g(f"{n}.bias"), eps=1e-6))
    x = q(F.conv2d(q(x), q(g("patch_embed.proj.weight")), g("patch_embed.proj.bias"), stride=cfg["patch"]))
    x = x.flatten(2).transpose(1, 2) + g("pos_embed")
    x = torch.cat([g("cls_token").expand(x.shape[0], -1, -1), x], 1)
    n, t, _ = x.shape
    qkv = lin("blocks.0.attn.qkv", ln("blocks.0.norm1", x)).reshape(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    s = q(q(qkv[0]) @ q(qkv[1]).transpose(-1, -2)) * (d // heads) ** -0.5
    a = q(q(s.softmax(-1)) @ q(qkv[2])).transpose(1, 2).reshape(n, t, d)
    x = q(x + g("blocks.0.ls1.gamma") * lin("blocks.0.attn.proj", a))
    y = lin("blocks.0.mlp.fc2", F.gelu(lin("blocks.0.mlp.fc1", ln("blocks.0.norm2", x))))
    x = q(x + g("blocks.0.ls2.gamma") * y)
    return ln("norm", x)[:, 0]


def toy_macs(cfg, size):
    d, patch, h = cfg["width"], cfg["patch"], cfg["mlp"]
    t = (size // patch) ** 2 + 1
    first = (t - 1) * d * 3 * patch * patch
    return first + t * (3 * d * d + 2 * t * d + d * d + 2 * d * h), first


@pytest.fixture
def toy(monkeypatch):
    mod = types.ModuleType("port_bench.reference.toy")
    mod.backbone_spec, mod.backbone, mod.backbone_macs = toy_spec, toy_backbone, toy_macs
    mod.embed_dim = lambda cfg: cfg["width"]
    monkeypatch.setitem(sys.modules, "port_bench.reference.toy", mod)
    return dict(TOY)


def test_toy_macs_by_hand(toy):
    # 16 patches of 8x8x3 -> 32; 17 tokens: qkv 32 -> 96, QK^T and PV
    # 17 x 17 x 32 each, proj 32 -> 32, MLP 32 -> 64 -> 32
    first = 16 * 32 * 3 * 64
    block = 17 * 32 * 96 + 2 * 17 * 17 * 32 + 17 * 32 * 32 + 2 * 17 * 32 * 64
    assert yardstick.backbone_macs(toy, 32) == (first + block, first) == (256064, 98304)


@pytest.mark.parametrize("name,size", [("toy", 32), ("resnet18", 64), ("resnet50", 64)])
def test_family_macs_match_torch_count(toy, name, size):
    """Every matrix product of one image's forward: the family's count is
    what torch's FLOP counter sees, halved."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = toy if name == "toy" else load("configs", name)
    p = weights.make_weights(nets.param_spec(cfg), 0, "cpu")
    x = torch.rand(1, 3, size, size)
    with FlopCounterMode(display=False) as counter:
        nets.Net(cfg, p).backbone(x, train=False)
    assert counter.get_total_flops() == 2 * yardstick.backbone_macs(cfg, size)[0]


def test_toy_spec_and_weights(toy):
    spec = nets.param_spec(toy, rsp_classes=RSP_CLASSES, head_classes=3)
    assert [e[0] for e in spec[:len(toy_spec(toy))]] == [e[0] for e in toy_spec(toy)]
    assert [e[0] for e in spec[len(toy_spec(toy)):]] == [
        "net.fc.0.weight", "net.fc.0.bias", "net.fc.2.weight", "net.fc.2.bias", "clf.classifier.0.weight",
        "clf.classifier.0.bias", "clf.classifier.2.weight", "clf.classifier.2.bias", "head.classifier.0.weight",
        "head.classifier.0.bias"]
    w = weights.make_weights(spec, 5, "cpu")
    # every drawn weight, in the spec's order, from one flat draw
    drawn = [e for e in spec if e[2] in ("conv", "linear", "normal")]
    flat = weights.truncated_normal(torch.Generator().manual_seed(5), sum(math.prod(e[1]) for e in drawn), "cpu")
    at = 0
    for name, shape, kind, *value in drawn:
        n = math.prod(shape)
        std = value[0] if kind == "normal" else nets.lecun_std(shape)
        assert torch.equal(w[name], (flat[at:at + n] * std).view(shape)), name
        at += n
    for name, shape, kind, *value in spec:
        assert w[name].shape == shape and w[name].dtype == torch.float32
        if kind == "fill":
            assert torch.all(w[name] == value[0]), name
        elif kind == "bias":
            assert not w[name].any(), name


def test_toy_step_flops(toy):
    macs, first = toy_macs(toy, 32)
    pair = 64 * 32 + 32 * 16
    rsp_head = 3 * pair + 48 * 16 + 16 * RSP_CLASSES
    assert yardstick.pretrain_step_flops(toy, 2, 32) == 2 * 3 * 2 * (3 * macs - first) + 2 * 2 * 3 * rsp_head
    head = pair + 48 * 3
    assert yardstick.finetune_step_flops(toy, 6, 32, 3) == 6 * 2 * (3 * (macs + head) - first)
    assert (yardstick.consistency_step_flops(toy, 10, 4, 32, 3)
            == 10 * 2 * (3 * (macs + head) - first) + 4 * 2 * (macs + head))


@pytest.mark.parametrize("stage", sorted(STAGE_MIX))
def test_toy_follows_every_stage(toy, stage):
    tr = dict(load("mixes", STAGE_MIX[stage]), classes=3)
    spec, out = first_steps(stage, toy, tr, steps=2)
    trained = [e[0] for e in spec]  # no BatchNorm statistics: every tensor is trained
    assert len(out["loss"]) == 2 and all(math.isfinite(v) for v in out["loss"])
    assert sorted(out["grad"]) == sorted(out["update"]) == sorted(trained)
    assert all(math.isfinite(v) and v > 0 for v in out["grad"].values())
    assert all(out["update"][k] > 0 for k in trained)


def test_toy_control_differs(toy):
    tr = dict(load("mixes", "finetune"), classes=3)
    _, plain = first_steps("finetune", toy, tr)
    _, fp8 = first_steps("finetune", toy, tr, quant=nets.fp8_train)
    assert math.isfinite(fp8["loss"][0]) and fp8["loss"][0] != plain["loss"][0]

"""The port's models and weight carry-over against the JAX package's flax
models (``ssl_cr_histo_tpu/models``, ``train/checkpoint.py``).

Weights are made by flax from a seed and carried over with
``from_jax_params``; inputs are made with numpy.  Everything runs in
float32 on the CPU."""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.train.checkpoint import export_torch_state_dict
from ssl_cr_histo_tpu_torch.models import Classifier, TripletNet
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params


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


IMG, B = 64, 2  # 64^2: layer4 is 2x2, so BN statistics are not degenerate


@pytest.fixture(scope="module")
def pair():
    """flax variables (trained-looking BN stats) + the port's modules
    carrying the same weights."""
    jm, jc = JTripletNet("resnet18"), JClassifier(num_classes=6)
    dummy = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    v = jm.init(k1, dummy, dummy, dummy, train=False)
    params = v["params"]
    # non-trivial running stats, so eval mode exercises them
    leaves, tdef = jax.tree_util.tree_flatten(v["batch_stats"])
    ks = jax.random.split(k3, len(leaves))
    stats = jax.tree_util.tree_unflatten(tdef, [
        l + 0.1 * jax.random.uniform(k, l.shape) for l, k in zip(leaves, ks)])
    head = jc.init(k2, jnp.zeros((1, 768)))["params"]
    sd, head_sd = from_jax_params(jax.device_get(params), jax.device_get(stats), jax.device_get(head))
    tm, tc = TripletNet("resnet18"), Classifier(768, 6)
    tm.load_state_dict(sd, strict=True)
    tc.load_state_dict(head_sd, strict=True)
    rng = np.random.default_rng(0)
    x = rng.random((B, 3, IMG, IMG, 3)).astype(np.float32)  # (B, views, H, W, C)
    return jm, jc, params, stats, head, tm, tc, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))  # (B, V, C, H, W)


def test_from_jax_params_equals_export_torch_state_dict(pair):
    """Same keys, same values (exact) as the JAX package's own exporter."""
    _, _, params, stats, head, *_ = pair
    sd, head_sd = from_jax_params(jax.device_get(params), jax.device_get(stats), jax.device_get(head))
    want = export_torch_state_dict(jax.device_get(params), jax.device_get(stats))
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
        assert sd[k].dtype == (torch.int64 if "num_batches" in k else torch.float32), k
    assert set(head_sd) == {"classifier.0.weight", "classifier.0.bias",
                            "classifier.2.weight", "classifier.2.bias"}
    np.testing.assert_array_equal(head_sd["classifier.2.weight"].numpy(),
                                  np.asarray(head["fc2"]["kernel"]).T)


# float32 ResNet18 forwards on the CPU: XLA and oneDNN sum the convolutions
# in different orders; train-mode BN divides by batch std over few samples,
# which amplifies that. atol 2e-4 / rtol 1e-3 on O(1) features.
FWD_TOL = dict(rtol=1e-3, atol=2e-4)


def test_triplet_eval_forward_matches_flax(pair):
    jm, jc, params, stats, head, tm, tc, x = pair
    tm.eval()
    tc.eval()
    v = {"params": params, "batch_stats": stats}
    want = jm.apply(v, x[:, 0], x[:, 1], x[:, 2], train=False)
    want_logits = jc.apply({"params": head}, want)
    xt = _nchw(x)
    with torch.no_grad():
        got = tm(xt[:, 0], xt[:, 1], xt[:, 2])
        joint = tm.forward_joint(xt)
        logits = tc(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(joint.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **FWD_TOL)
    want_single = jm.apply(v, x[:, 0], train=False, method=jm.encode_single)
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode_single(xt[:, 0]).numpy(), np.asarray(want_single), **FWD_TOL)


def _bn_counts(net, forward):
    counts, hooks = {}, []
    for name, m in net.named_modules():
        if isinstance(m, tnn.BatchNorm2d):
            def hook(mod, inp, out, name=name):
                counts[name] = counts.get(name, 0) + inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3]
            hooks.append(m.register_forward_hook(hook))
    forward()
    for h in hooks:
        h.remove()
    return counts


@pytest.mark.parametrize("joint", [True, False])
def test_triplet_train_forward_and_bn_stats_match_flax(pair, joint):
    """Train mode: features, and the BN running statistics after one forward.
    running_mean compares directly; running_var after removing torch's
    unbiased n/(n-1) factor analytically, as
    tests/test_torch_training_parity.py:122-141 does.  Per-view (joint=False)
    means three BN updates per layer, each with its own batch."""
    jm, _, params, stats, head, _, _, x = pair
    sd, _ = from_jax_params(jax.device_get(params), jax.device_get(stats))
    tm = TripletNet("resnet18")
    tm.load_state_dict(sd)
    tm.train()
    v = {"params": params, "batch_stats": stats}
    xt = _nchw(x)
    if joint:
        want, mut = jm.apply(v, x, train=True, mutable=["batch_stats"], method=jm.forward_joint)
        fwd = lambda: tm.forward_joint(xt)
    else:
        want, mut = jm.apply(v, x[:, 0], x[:, 1], x[:, 2], train=True, mutable=["batch_stats"])
        fwd = lambda: tm(xt[:, 0], xt[:, 1], xt[:, 2])
    out = {}
    with torch.no_grad():
        counts = _bn_counts(tm, lambda: out.setdefault("feats", fwd()))
    np.testing.assert_allclose(out["feats"].numpy(), np.asarray(want), **FWD_TOL)

    flax_sd = export_torch_state_dict(jax.device_get(params), jax.device_get(mut["batch_stats"]))
    start = export_torch_state_dict(jax.device_get(params), jax.device_get(stats))
    n_upd = 1 if joint else 3
    decay = 0.9 ** n_upd
    for key, val in tm.state_dict().items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(val.numpy(), flax_sd[key], rtol=1e-3, atol=1e-5, err_msg=key)
        elif key.endswith("running_var"):
            mod = key[: -len(".running_var")]
            n = counts[mod] // n_upd
            c = n / (n - 1)
            base = decay * start[key]
            np.testing.assert_allclose(val.numpy() - base, c * (flax_sd[key] - base),
                                       rtol=1e-3, atol=1e-5, err_msg=key)


def test_resnet50_weights_carry_over():
    """Bottleneck naming: the JAX ResNet50 TripletNet's weights load strictly
    into the port's, and the eval forwards agree (FWD tolerance)."""
    jm = JTripletNet("resnet50")
    x = np.random.default_rng(3).random((1, 32, 32, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(1), x, x, x, train=False)
    sd, _ = from_jax_params(jax.device_get(v["params"]), jax.device_get(v["batch_stats"]))
    tm = TripletNet("resnet50")
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    want = jm.apply(v, x, x, x, train=False)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = tm(xt, xt, xt)
    assert got.shape == (1, 1536)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("model_name", ["resnet18", "resnet50"])
def test_initialisation_matches_flax(model_name):
    """A fresh model starts as flax starts the JAX package's: each Conv and
    Dense kernel from lecun_normal (a normal truncated at two standard
    deviations, variance 1 / fan_in), biases 0, BatchNorm at scale 1 and
    bias 0 with running statistics 0 and 1.  Tensor by tensor against
    flax's draws from a key: the same bound, and the same spread within
    sampling error (tensors of 2000 entries or more)."""
    from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
    from ssl_cr_histo_tpu_torch.models import FinetuneHead, feature_dim

    x = np.zeros((1, 32, 32, 3), np.float32)
    v = JTripletNet(model_name).init(jax.random.PRNGKey(0), x, x, x, train=False)
    d = feature_dim(model_name)
    jhead = JClassifier(num_classes=6).init(jax.random.PRNGKey(1), jnp.zeros((1, d)))["params"]
    want, want_head = from_jax_params(jax.device_get(v["params"]), jax.device_get(v["batch_stats"]),
                                      jax.device_get(jhead))
    jft = JFinetuneHead(num_classes=9).init(jax.random.PRNGKey(2), jnp.zeros((1, d)))["params"]["fc"]
    want_ft = {"classifier.0.weight": torch.from_numpy(np.asarray(jft["kernel"]).T.copy()),
               "classifier.0.bias": torch.from_numpy(np.array(jft["bias"]))}
    torch.manual_seed(0)
    pairs = [(TripletNet(model_name).state_dict(), want), (Classifier(d, 6).state_dict(), want_head),
             (FinetuneHead(d, 9).state_dict(), want_ft)]
    for got_sd, want_sd in pairs:
        assert set(got_sd) == set(want_sd)
        for k, w in want_sd.items():
            g = got_sd[k].double()
            w = torch.as_tensor(np.asarray(w)).double()
            assert g.shape == w.shape, k
            if k.endswith(("bias", "running_mean")) or "num_batches" in k:
                assert not g.any() and not w.any(), k
            elif k.endswith("running_var") or g.dim() == 1:  # BN statistics and scales
                assert (g == 1).all() and (w == 1).all(), k
            else:
                fan_in = g[0].numel()
                bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
                assert g.abs().max() <= bound * (1 + 1e-6) and w.abs().max() <= bound * (1 + 1e-6), k
                if g.numel() >= 2000:
                    # the std of n draws strays ~1/sqrt(2n) relatively; 6 of those
                    tol = 6 / np.sqrt(2 * g.numel())
                    for t in (g, w):
                        assert abs(t.std().item() * np.sqrt(fan_in) - 1.0) < tol, k
                    assert abs(g.mean().item()) < 6 * g.std().item() / np.sqrt(g.numel()), k

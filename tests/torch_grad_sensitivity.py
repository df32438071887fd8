"""How far a randomly initialised resnet18's gradients move when its input
views move a little, and how close the port and the JAX package are on
equal views: the reason tests/test_torch_finetune.py runs the port's
fine-tune step on the JAX package's own views.

    JAX_PLATFORMS=cpu python tests/torch_grad_sensitivity.py

One Kather-shaped batch as in ``test_finetune_step_matches_jax[kather-0]``
(4 uint8 images of 64^2 from numpy seed 20, the 3-view draws of JAX key 1,
9-way CE on ``encode_single`` over the 12 views, weights by flax from
seed 0).  Backbone gradients in float64 on both sides (the port's features
reach the pairwise fc in float32).  Prints, per comparison, the largest
per-tensor error relative to the tensor's largest gradient, and where:
  1. JAX vs the port, on JAX's views;
  2. the port on its own views (the same draws; up to 1.1e-5 away from
     JAX's under float64) vs the port on JAX's views;
  3. the port on JAX's views plus N(0, 1e-5) noise vs on JAX's views.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead  # noqa: E402
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet  # noqa: E402
from ssl_cr_histo_tpu.ops import batch as JB  # noqa: E402
from ssl_cr_histo_tpu.parallel import steps as JS  # noqa: E402
from ssl_cr_histo_tpu.train.checkpoint import export_torch_state_dict  # noqa: E402
from ssl_cr_histo_tpu_torch.models import FinetuneHead, TripletNet  # noqa: E402
from ssl_cr_histo_tpu_torch.ops import batch as TB  # noqa: E402
from ssl_cr_histo_tpu_torch.parallel import steps as TS  # noqa: E402
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params  # noqa: E402

IMG, B = 64, 4


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    jm = JTripletNet("resnet18")
    dummy = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), dummy, train=False, method=jm.encode_single))
    head = jax.device_get(JFinetuneHead(9).init(jax.random.PRNGKey(9), jnp.zeros((1, 768)))["params"])
    rng = np.random.default_rng(20)
    imgs = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    labels = np.repeat(rng.integers(0, 9, B).astype(np.int32), 3)
    key = jax.random.PRNGKey(1)

    with jax.enable_x64():
        jviews = np.asarray(JB.augment_3view_batch(key, jnp.asarray(imgs)))
        draws = {"angles": [], "rotate": [], "crop": [], "perm": []}
        for k in jax.random.split(key, B):
            k2a, k2p, k3a, k3p, k3c, kshuf = jax.random.split(k, 6)
            draws["angles"].append([float(jax.random.uniform(a, (), minval=-90.0, maxval=90.0)) for a in (k2a, k3a)])
            draws["rotate"].append([bool(jax.random.bernoulli(p)) for p in (k2p, k3p)])
            draws["crop"].append([int(jax.random.randint(c, (), 0, 21)) for c in jax.random.split(k3c)])
            draws["perm"].append(np.asarray(jax.random.permutation(kshuf, 3)).tolist())
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jm64, jh64 = JTripletNet("resnet18", dtype=jnp.float64), JFinetuneHead(9, dtype=jnp.float64)
        params = {"model": f64(v["params"]), "head": f64(head)}

        def loss_fn(p):
            feats, _ = jm64.apply({"params": p["model"], "batch_stats": f64(v["batch_stats"])},
                                  jnp.asarray(jviews.reshape(-1, IMG, IMG, 3), jnp.float64), train=True,
                                  mutable=["batch_stats"], method=jm64.encode_single)
            return JS.cross_entropy(jh64.apply({"params": p["head"]}, feats), jnp.asarray(labels))

        jgrads = export_torch_state_dict(jax.device_get(jax.grad(loss_fn)(params))["model"], {})
    draws = {k: torch.tensor(val) for k, val in draws.items()}
    draws["angles"] = draws["angles"].float()
    own = TB.augment_3view_batch(torch.Generator(), torch.from_numpy(imgs), draws)
    jplanar = torch.from_numpy(np.array(jviews)).permute(0, 1, 4, 2, 3)

    def port_grads(views):
        sd, head_sd = from_jax_params(v["params"], v["batch_stats"], head)
        model, h = TripletNet("resnet18"), FinetuneHead(768, 9)
        model.load_state_dict(sd)
        h.load_state_dict(head_sd)
        model.model.double()
        x = views.reshape(-1, 3, IMG, IMG).double()
        TS.cross_entropy(h(model.encode_single(x)), torch.from_numpy(labels)).backward()
        return {k: p.grad.double().numpy() for k, p in model.named_parameters()}

    def worst(a, b):
        errs = {k: np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() for k in b}
        k = max(errs, key=errs.get)
        return f"{errs[k]:.2e} ({k})"

    base = port_grads(jplanar)
    noisy = jplanar + 1e-5 * torch.randn(jplanar.shape, generator=torch.Generator().manual_seed(0))
    print(f"views: the port's own vs JAX's, max abs {(own - jplanar).abs().max().item():.2e}")
    print(f"1. JAX vs the port, equal views: {worst(base, jgrads)}")
    print(f"2. the port, its own views vs JAX's: {worst(port_grads(own), base)}")
    print(f"3. the port, JAX's views + N(0, 1e-5) vs JAX's views: {worst(port_grads(noisy), base)}")


if __name__ == "__main__":
    main()

"""The port's last library modules against the JAX package's functions on
seeded numpy inputs: ``ops/color.py``'s ``rgb2lab`` and
``rgb_to_luminance``, ``train/optim.py``'s ``radam`` and
``utils/profiling.py`` (``trace``, ``StepTimer``, ``Throughput``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_cr_histo_tpu.ops import color as JC
from ssl_cr_histo_tpu.train import optim as JO
from ssl_cr_histo_tpu.utils import profiling as JP
from ssl_cr_histo_tpu_torch.ops import color as TC
from ssl_cr_histo_tpu_torch.train import optim as TO
from ssl_cr_histo_tpu_torch.utils import profiling as TP


def rgb_batch(seed: int) -> np.ndarray:
    """(4, 16, 16, 3) float32 RGB in [0, 1] with the corner cases of the
    companding and of the cube root's linear branch: black, white, values
    at and around 0.04045, and a dark ramp."""
    img = np.random.default_rng(seed).random((4, 16, 16, 3), dtype=np.float32)
    img[0, 0, :3] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.04045, 0.04045]]
    img[0, 1, :16] = np.linspace(0.0, 0.08, 16, dtype=np.float32)[:, None]
    return img


def planar(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rgb2lab_matches_jax(seed):
    """Float32 both.  A float32 ulp of the cube root is 6e-8, and a and b
    scale differences of cube roots by 500 and 200, so one ulp there is 3e-5
    in a: the bound is 1e-5 of each channel's largest magnitude (L reaches
    100, a and b ~100 here)."""
    img = rgb_batch(seed)
    want = np.asarray(JC.rgb2lab(jnp.asarray(img)))
    got = TC.rgb2lab(planar(img)).numpy().transpose(0, 2, 3, 1)
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).reshape(-1, 3).max(axis=0)
    err = np.abs(got - want).reshape(-1, 3).max(axis=0)
    assert (err <= 1e-5 * scale).all(), (err, scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_rgb_to_luminance_matches_jax(seed):
    img = rgb_batch(seed)
    want = np.asarray(JC.rgb_to_luminance(jnp.asarray(img)))
    got = TC.rgb_to_luminance(planar(img)).numpy()
    assert got.shape == want.shape == (4, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def radam_trajectories(dtype, weight_decay: float, steps: int = 20, lr: float = 1e-2):
    """Parameters after ``steps`` updates of optax's RAdam (the JAX
    package's ``radam``) and the port's, from the same seeded start, with
    the gradient g_t + p**2 each framework computes from its own
    parameters (g_t seeded)."""
    rng = np.random.default_rng(7)
    p0 = {"w": rng.normal(size=(4, 3)).astype(dtype), "b": rng.normal(size=(3,)).astype(dtype)}
    grads = [{k: rng.normal(size=v.shape).astype(dtype) for k, v in p0.items()} for _ in range(steps)]

    def run_jax():
        tx = JO.radam(lr, weight_decay=weight_decay)
        p = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(p)
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(g[k]) + p[k] ** 2 for k in g}, state, p)
            p = optax.apply_updates(p, updates)
        return {k: np.asarray(v) for k, v in p.items()}

    if dtype == np.float64:
        with jax.enable_x64():
            want = run_jax()
    else:
        want = run_jax()
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = TO.radam(list(params.values()), lr, weight_decay=weight_decay)
    assert isinstance(opt, torch.optim.RAdam)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]) + p.detach() ** 2
        opt.step()
    got = {k: p.detach().numpy() for k, p in params.items()}
    moved = max(np.abs(want[k] - p0[k]).max() for k in p0)
    return want, got, moved


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_matches_optax_float64(weight_decay):
    """20 steps in float64: the two differ only in where eps sits
    (optax: m / (sqrt(v_hat) + eps); torch: m / (sqrt(v_hat) + eps /
    sqrt(1 - b2^t))), worth ~5e-10 here against a ~0.09 move; bound 1e-8."""
    want, got, moved = radam_trajectories(np.float64, weight_decay)
    assert moved > 0.05
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float64
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8)


def test_radam_matches_optax_float32():
    """20 steps in float32, weight decay on.  optax computes the
    rectification's rho_t in float32, where 1 - b2^t loses ~5 digits, so
    its rectifier moves by ~1% from step 6 on; torch computes rho_t in
    Python floats.  Bound 1e-4 against a ~0.09 move."""
    want, got, moved = radam_trajectories(np.float32, 1e-2)
    assert moved > 0.05
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


class Scalar:
    """A step's scalar: counts the host fetches ``float`` makes of it."""

    def __init__(self):
        self.fetches = 0

    def __float__(self):
        self.fetches += 1
        return 1.0


def test_step_timer_matches_the_original(monkeypatch):
    """Same clock readings, same elapsed times; ``elapsed(x)`` fetches x to
    the host (a sync) before reading the clock, ``elapsed()`` does not."""
    out = {}
    for mod in (JP, TP):
        monkeypatch.setattr(mod.time, "time", FakeClock([10.0, 10.5, 11.25, 20.0, 20.125]))
        timer, scalar = mod.StepTimer(), Scalar()
        timer.reset()  # the constructor's default reads the clock it was defined with
        out[mod] = [timer.elapsed(scalar), timer.elapsed()]
        timer.reset()
        out[mod].append(timer.elapsed(scalar))
        assert scalar.fetches == 2
    assert out[TP] == out[JP] == [0.5, 1.25, 0.125]


@pytest.mark.parametrize("window", [1, 3, 50])
def test_throughput_matches_the_original(window):
    """The same sliding window: items/s after each update equal the
    original's, the window dropping the oldest step."""
    rng = np.random.default_rng(window)
    meters = (JP.Throughput(window=window), TP.Throughput(window=window))
    assert meters[0].items_per_sec == meters[1].items_per_sec == 0.0
    for _ in range(8):
        n, secs = int(rng.integers(1, 100)), float(rng.random()) + 0.01
        for m in meters:
            m.update(n, secs)
        assert meters[1].items_per_sec == meters[0].items_per_sec
    assert len(meters[1]._times) == min(window, 8)
    # a step of no time: with a window of one the meter reads 0, not a division by 0
    for m in meters:
        m.update(5, 0.0)
    assert meters[1].items_per_sec == meters[0].items_per_sec
    assert window > 1 or meters[1].items_per_sec == 0.0


def test_trace_writes_a_profiler_trace(tmp_path):
    """``trace(logdir)`` profiles the block with torch.profiler and writes
    the trace under logdir when the block ends."""
    logdir = str(tmp_path / "trace")
    with TP.trace(logdir) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert any("aten::mm" in e.key for e in prof.key_averages())

"""The v1 pretraining photometric chain: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Counterpart of ``ssl_cr_histo_tpu/ops/pallas_photometric.py``.  The chain,
per tile, with per-tile parameters (``draw_params``):

    HSV shift (p=.5) -> additive Gaussian noise (p=.5) -> HED stain shift
    -> box blur 3/5/7 with reflect101 borders (p=.5)
    -> brightness/contrast (p=.5)

``pretrain_photometric`` dispatches on the device of its input: a CPU tensor
runs the plain chain (``reference_chain``), a CUDA tensor launches the kernel
in ``csrc/photometric_chain.cu`` or raises.  It never falls back from the
kernel to the plain chain.

Noise: the Pallas kernel draws from the TPU core's own generator, which no
other device reproduces.  The port's kernels draw from a counter-based
Philox4x32-10 keyed on a per-tile seed, one call per pixel with the counter
(x, y, tile, 0) giving all three channels, and ``philox_normal`` computes
the same numbers in plain PyTorch, so
the kernel's random mode is checkable element for element.  Passing
``noise`` explicitly (the Pallas package's ``_kernel_noise_input`` mode)
ties kernel, plain chain and the JAX package together on the same inputs.
"""

from __future__ import annotations

import ctypes

import torch

from ssl_cr_histo_tpu_torch.ops import color, photometric

# params vector layout (float32), as ``pallas_photometric.py:34-40``:
#   0: hue_shift   1: sat_shift   2: val_shift   3: hsv_gate
#   4: noise_sigma 5: noise_gate
#   6: hed_dh      7: hed_de      8: hed_dd
#   9: blur_ksize (3/5/7)         10: blur_gate
#  11: brightness 12: contrast    13: bc_gate
N_PARAMS = 16

# Kernel launches made by ``pretrain_photometric`` (incremented only where
# the CUDA kernel is launched).
launches = 0

_RGB_FROM_HED = tuple(tuple(float(v) for v in row) for row in color.RGB_FROM_HED)
_HED_FROM_RGB = tuple(tuple(float(v) for v in row) for row in color.HED_FROM_RGB)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def draw_params(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, N_PARAMS) per-tile parameters with the law of
    ``pallas_photometric.draw_params`` (``:275-299``)."""
    dev = gen.device
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(n, *shape, generator=gen, device=dev)
    coin = lambda: (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    p = torch.zeros(n, N_PARAMS, dtype=torch.float32, device=dev)
    p[:, 0] = u(-0.1, 0.1)
    p[:, 1] = u(-1.0, 1.0)
    p[:, 2] = u(-20.0, 20.0)
    p[:, 3] = coin()
    p[:, 4] = u(0.0, 0.1)
    p[:, 5] = coin()
    sigma = u(-0.035, 0.035, 3)
    p[:, 6:9] = torch.randn(n, 3, generator=gen, device=dev) * sigma
    p[:, 9] = 3.0 + 2.0 * torch.randint(0, 3, (n,), generator=gen, device=dev).float()
    p[:, 10] = coin()
    p[:, 11] = u(-0.2, 0.2)
    p[:, 12] = u(-0.2, 0.2)
    p[:, 13] = coin()
    return p


def draw_seeds(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n,) int32 per-tile noise seeds."""
    return torch.randint(0, 2**31 - 1, (n,), generator=gen, device=gen.device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Philox4x32-10 and Box-Muller, plain PyTorch on int64 tensors
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    # x < 2**32 and m < 2**32: the 64-bit product wraps in int64, and its
    # two 32-bit halves are still exact after masking.
    prod = x * m
    return (prod >> 32) & _MASK, prod & _MASK


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words.  ctr: 4 tensors, key: 2 tensors (broadcastable); returns the 4
    output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in (0, 1): (k + 0.5) * 2**-23 for the top
    23 bits k, exact in float32 and never 0 or 1."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def philox_normal(seeds: torch.Tensor, shape) -> torch.Tensor:
    """The kernels' per-pixel N(0, 1) noise for (N, 3, H, W) tiles: one
    Philox call per pixel, keyed on (seed[n], 0) at counter (x, y, n, 0).
    Box-Muller on words 0-1 gives channels 0 (cos) and 1 (sin), on words 2-3
    channel 2 (cos), as ``csrc/photometric_common.cuh`` computes them."""
    n, c, h, w = shape
    if c != 3:
        raise ValueError(f"philox_normal draws 3 channels, got shape {tuple(shape)}")
    dev = seeds.device
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ctr = (ar(w).view(1, 1, w), ar(h).view(1, h, 1), ar(n).view(n, 1, 1), zero)
    key = (seeds.to(torch.int64).view(n, 1, 1) & _MASK, zero)
    b0, b1, b2, b3 = philox4x32(ctr, key)
    two_pi = 6.283185307179586
    r01 = torch.sqrt(-2.0 * torch.log(_uniform_open(b0)))
    r2 = torch.sqrt(-2.0 * torch.log(_uniform_open(b2)))
    t01 = two_pi * _uniform_open(b1)
    return torch.stack([r01 * torch.cos(t01), r01 * torch.sin(t01),
                        r2 * torch.cos(two_pi * _uniform_open(b3))], 1)


# ---------------------------------------------------------------------------
# The plain chain (``pallas_photometric.py:53-196``), batched over tiles;
# every per-tile parameter is an (N, 1, 1) tensor
# ---------------------------------------------------------------------------


def _mat3_apply(c0, c1, c2, m):
    return (
        c0 * m[0][0] + c1 * m[1][0] + c2 * m[2][0],
        c0 * m[0][1] + c1 * m[1][1] + c2 * m[2][1],
        c0 * m[0][2] + c1 * m[1][2] + c2 * m[2][2],
    )


def _hed_shift(r, g, b, dh, de, dd):
    """Legacy-skimage HED shift (``pallas_photometric.py:132-139``)."""
    lr0, lg0, lb0 = -torch.log(r + 2.0), -torch.log(g + 2.0), -torch.log(b + 2.0)
    h, e, d = _mat3_apply(lr0, lg0, lb0, _HED_FROM_RGB)
    h, e, d = h + dh, e + de, d + dd
    lr, lg, lb = _mat3_apply(-h, -e, -d, _RGB_FROM_HED)
    clip = lambda x: torch.clamp((torch.exp(x) - 1.0) / 2.0, 0.0, 1.0)
    return clip(lr), clip(lg), clip(lb)


def _chain_planes(r, g, b, p, noise):
    """The chain on (N, H, W) color planes in compute-then-select form;
    ``p`` is a sequence of N_PARAMS (N, 1, 1) tensors, ``noise`` a 3-tuple
    of (N, H, W) standard normal planes."""

    def gated(gate, new, old):
        return tuple(torch.where(gate > 0.5, a, o) for a, o in zip(new, old))

    h, s, v = color.rgb2hsv_planes(r, g, b)
    h = torch.remainder(h + p[0] / 180.0, 1.0)
    s = torch.clamp(s + p[1] / 255.0, 0.0, 1.0)
    v = torch.clamp(v + p[2] / 255.0, 0.0, 1.0)
    r, g, b = gated(p[3], color.hsv2rgb_planes(h, s, v), (r, g, b))

    noisy = tuple(torch.clamp(x + nz * p[4], 0.0, 1.0) for x, nz in zip((r, g, b), noise))
    r, g, b = gated(p[5], noisy, (r, g, b))

    r, g, b = _hed_shift(r, g, b, p[6], p[7], p[8])

    r, g, b = gated(p[10], tuple(photometric.box_blur_planes(x, p[9]) for x in (r, g, b)), (r, g, b))

    bc = lambda x: torch.clamp(x * (1.0 + p[12]) + p[11], 0.0, 1.0)
    return gated(p[13], tuple(bc(x) for x in (r, g, b)), (r, g, b))


def reference_chain(imgs: torch.Tensor, params: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, 3, H, W) float32 tiles,
    (N, N_PARAMS) params and (N, 3, H, W) standard normal noise in, same
    shape out (``pallas_photometric.py:354-367``, planar)."""
    p = [params[:, j].view(-1, 1, 1) for j in range(N_PARAMS)]
    planes = _chain_planes(imgs[:, 0], imgs[:, 1], imgs[:, 2], p,
                           (noise[:, 0], noise[:, 1], noise[:, 2]))
    return torch.stack(planes, 1)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _hed_mats() -> "ctypes.Array":
    flat = [v for row in _HED_FROM_RGB for v in row] + [v for row in _RGB_FROM_HED for v in row]
    return (ctypes.c_float * 18)(*flat)


def _library():
    from ssl_cr_histo_tpu_torch.csrc import build

    lib = build.load_library("photometric_chain")
    fn = lib.launch_photometric_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def photometric_chain_cuda(imgs: torch.Tensor, seeds: torch.Tensor, params: torch.Tensor,
                           noise: "torch.Tensor | None" = None) -> torch.Tensor:
    """Launch the CUDA kernel on (N, 3, H, W) float32 CUDA tiles.  With
    ``noise`` None the kernel draws Philox noise from ``seeds``; otherwise it
    reads ``noise`` (same shape as ``imgs``)."""
    global launches
    if not imgs.is_cuda:
        raise ValueError("photometric_chain_cuda needs CUDA tensors")
    if imgs.dim() != 4 or imgs.shape[1] != 3:
        raise ValueError(f"expected (N, 3, H, W) tiles, got {tuple(imgs.shape)}")
    n, _, h, w = imgs.shape
    dev = imgs.device
    _check(imgs, "imgs", torch.float32, imgs.shape, dev)
    _check(seeds, "seeds", torch.int32, (n,), dev)
    _check(params, "params", torch.float32, (n, N_PARAMS), dev)
    if noise is not None:
        _check(noise, "noise", torch.float32, imgs.shape, dev)
    fn = _library()
    out = torch.empty_like(imgs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(imgs.data_ptr(), 0 if noise is None else noise.data_ptr(), seeds.data_ptr(),
                params.data_ptr(), out.data_ptr(), n, h, w, ctypes.addressof(_HED_MATS), stream)
    if rc != 0:
        raise RuntimeError(f"photometric_chain kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


_HED_MATS = _hed_mats()


def pretrain_photometric(imgs: torch.Tensor, generator: torch.Generator,
                         noise: "torch.Tensor | None" = None,
                         params: "torch.Tensor | None" = None) -> torch.Tensor:
    """Photometric chain over (N, 3, H, W) float32 tiles in [0, 1].

    params: (N, N_PARAMS), drawn from ``generator`` when None.  noise:
    (N, 3, H, W) standard normal; when None the kernel's Philox noise is
    used (per-tile seeds drawn from ``generator``).  CPU tensors run the
    plain chain; CUDA tensors run the kernel.
    """
    n = imgs.shape[0]
    if params is None:
        params = draw_params(generator, n)
    seeds = draw_seeds(generator, n)
    if imgs.is_cuda:
        return photometric_chain_cuda(imgs, seeds, params, noise)
    if imgs.device.type != "cpu":
        raise ValueError(f"no photometric chain for device {imgs.device}")
    if noise is None:
        noise = philox_normal(seeds, imgs.shape)
    return reference_chain(imgs, params, noise)

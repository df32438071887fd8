"""WSI tumour-probability heatmaps: the port's counterpart of
``ssl_cr_histo_tpu/eval/heatmap.py`` (reference test_Camelyon16.py).

The tissue mask's nonzero cells are the work list; a patch of ``image_size``
centred on each cell's level-0 point goes through the eval-mode forward, and
the softmax's last column (tumour) lands in the mask-sized map.

The serving loop is a pipeline in PyTorch's idiom:
  * a prefetch thread reads each batch's patches on a pool of
    ``IO_THREADS`` threads straight into a pinned host buffer, ``PREFETCH``
    batches ahead;
  * the consumer starts the buffer's copy to the card with
    ``non_blocking``, issues the forward, and starts the logits' copy back
    into pinned host memory with ``non_blocking``, recording a CUDA event
    after it;
  * batch k is drained (softmax, scatter into the map) only after batch
    k+1's forward has been issued, waiting on k's event, so the host's
    softmax and scatter run while the card computes.  Nothing in the loop
    calls ``.cpu()`` or ``np.asarray`` on a CUDA tensor.
The last batch is short: the forward is eval mode, so each patch's logits
depend on that patch alone, and padding (a TPU compile concern) would not
change the map.

Reference behaviour kept as the JAX package keeps it: pixels are
normalised as in training (the reference feeds raw 0..255 floats at test
time, dataset.py:994), and the trained head is loaded (the reference leaves
it random, test_Camelyon16.py:126-127).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.data.pipeline import prefetch_iter
from ssl_cr_histo_tpu_torch.data.wsi import PyramidReader

# matplotlib's 'jet' (matplotlib/_cm.py ``_jet_data``): (x, y0, y1) per channel
_JET = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1), (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.00, 0, 0)),
}
IO_THREADS = 8  # threads reading one batch's patches
PREFETCH = 2  # batches read ahead of the forward


def pair_wsi_masks(wsipaths, maskpaths) -> list:
    """Pair each WSI with its tissue mask by basename: the mask's stem is
    ``{wsi_id}``, ``{wsi_id}_mask`` or ``{wsi_id}_tissue``.  Raises
    ValueError listing every unmatched file (the reference zips two sorted
    listings, test_Camelyon16.py:148, so one missing mask shifts every later
    pair; the JAX package's fix, kept here)."""
    masks = {os.path.splitext(os.path.basename(mp))[0]: mp for mp in maskpaths}
    pairs, missing = [], []
    for wp in sorted(wsipaths):
        wid = os.path.splitext(os.path.basename(wp))[0]
        mp = None
        for stem in (wid, f"{wid}_mask", f"{wid}_tissue"):
            mp = masks.pop(stem, None)
            if mp is not None:
                break
        if mp is None:
            missing.append(wid)
        else:
            pairs.append((wp, mp))
    if missing or masks:
        raise ValueError("WSI/mask pairing failed — WSIs without a {id,id_mask,id_tissue} "
                         f"mask: {missing or 'none'}; masks without a WSI: {sorted(masks) or 'none'}")
    return pairs


def mask_work_list(reader: PyramidReader, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Check the slide/mask scale (one power of 2 on both axes, reference
    dataset.py:958-978) and return (x_idcs, y_idcs, resolution) of the
    mask's nonzero cells."""
    x_slide, y_slide = reader.level_dimensions[0]
    x_mask, y_mask = mask.shape
    if round(x_slide / x_mask) != round(y_slide / y_mask):
        raise ValueError(f"slide/mask dimension mismatch: {x_slide}/{x_mask} vs {y_slide}/{y_mask}")
    resolution = round(x_slide / x_mask)
    if not float(np.log2(resolution)).is_integer():
        raise ValueError(f"slide/mask resolution {resolution} is not a power of 2")
    x_idcs, y_idcs = np.where(mask)
    return x_idcs, y_idcs, resolution


def iter_patch_batches(reader: PyramidReader, x_idcs: np.ndarray, y_idcs: np.ndarray, resolution: int,
                       image_size: int, batch_size: int,
                       pin: bool = False) -> Iterator[Tuple[torch.Tensor, np.ndarray, np.ndarray]]:
    """(patches uint8 (b, S, S, 3), x_mask, y_mask) batches in work-list
    order, the last one short.  ``IO_THREADS`` threads read the patches
    straight into the batch's host tensor, pinned when ``pin``."""
    n = len(x_idcs)
    with ThreadPoolExecutor(max_workers=IO_THREADS) as pool:
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            buf = torch.empty((stop - start, image_size, image_size, 3), dtype=torch.uint8, pin_memory=pin)
            out = buf.numpy()

            def read_one(i: int) -> None:
                x = int(x_idcs[i] * resolution - image_size / 2)
                y = int(y_idcs[i] * resolution - image_size / 2)
                out[i - start] = reader.read_region((x, y), 0, (image_size, image_size))

            list(pool.map(read_one, range(start, stop)))
            yield buf, x_idcs[start:stop], y_idcs[start:stop]


def _to_host(logits: torch.Tensor) -> Tuple[torch.Tensor, "torch.cuda.Event | None"]:
    """Start the logits' copy to pinned host memory without blocking and
    record an event after it; on the CPU, the logits themselves."""
    if logits.device.type != "cuda":
        return logits, None
    host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
    host.copy_(logits, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _drain(pending, probs_map: np.ndarray) -> None:
    """Wait for a batch's logits to reach the host, then scatter its
    tumour probabilities (softmax's last column, the JAX package's numpy
    formula) into the map."""
    host, event, xs, ys = pending
    if event is not None:
        event.synchronize()
    logits = host.numpy()
    ex = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs_map[xs, ys] = (ex / ex.sum(axis=-1, keepdims=True))[:, -1]


def compute_probs_map(reader: PyramidReader, mask: np.ndarray, forward_fn: Callable[[torch.Tensor], torch.Tensor],
                      device: torch.device, image_size: int = 256, batch_size: int = 256) -> np.ndarray:
    """The (X_mask, Y_mask) float32 tumour-probability map of one slide
    (reference test_Camelyon16.py:30-70; ``heatmap.py:110-161``).

    forward_fn: uint8 (b, S, S, 3) patches on ``device`` -> (b, 2) float32
    logits on ``device``, issued without waiting for the card (such as
    ``parallel.steps.forward``).  The pipeline is the module docstring's."""
    x_idcs, y_idcs, resolution = mask_work_list(reader, mask)
    probs_map = np.zeros(mask.shape, np.float32)
    pinned = device.type == "cuda"
    batches = iter_patch_batches(reader, x_idcs, y_idcs, resolution, image_size, batch_size, pinned)
    pending = None
    for patches, xs, ys in prefetch_iter(batches, size=PREFETCH):
        issued = (*_to_host(forward_fn(patches.to(device, non_blocking=pinned))), xs, ys)
        if pending is not None:
            _drain(pending, probs_map)
        pending = issued
    if pending is not None:
        _drain(pending, probs_map)
    return probs_map


def jet_lut() -> np.ndarray:
    """(256, 4) float64 RGBA table of matplotlib's 'jet', built from its
    segment data as ``LinearSegmentedColormap`` builds it
    (``_create_lookup_table`` with N 256 and gamma 1; alpha 1)."""
    n = 256
    lut = np.ones((n, 4))
    xind = (n - 1) * np.linspace(0, 1, n)
    for c, name in enumerate(("red", "green", "blue")):
        data = np.asarray(_JET[name], np.float64)
        x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut[:, c] = np.clip(np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]]),
                            0.0, 1.0)
    return lut


def jet_rgba(values: np.ndarray) -> np.ndarray:
    """uint8 RGBA of ``values`` in [0, 1] through ``jet_lut``, with
    ``Colormap.__call__``'s index rule: ``x * 256`` in the values' dtype,
    256 taken as 255, truncated; then ``np.uint8(rgba * 255)`` as the JAX
    package writes it."""
    xa = np.array(values, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    return np.uint8(jet_lut()[xa.astype(int)] * 255)


def save_heatmap_artifacts(probs_map: np.ndarray, out_dir: str, wsi_id: str) -> bool:
    """The reference's artifacts (test_Camelyon16.py:168-189) under
    ``out_dir``: ``{wsi_id}.npy``, the grey ``{wsi_id}.png`` and the jet
    ``{wsi_id}_heatmap.png``, none of which needs matplotlib; and the
    colour-bar figure ``{wsi_id}_heatmap_bar.png`` when matplotlib imports.
    The PNGs are written with Pillow, as the JAX package writes them.
    Returns whether the bar figure was written."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, wsi_id), probs_map)
    pm = np.transpose(probs_map)
    Image.fromarray(np.uint8(pm * 255)).save(os.path.join(out_dir, f"{wsi_id}.png"))
    Image.fromarray(jet_rgba(np.clip(pm, 0, 1))).save(os.path.join(out_dir, f"{wsi_id}_heatmap.png"))
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imshow(pm, cmap="jet", interpolation="nearest")
    plt.colorbar()
    plt.clim(0.0, 1.0)
    plt.axis("off")
    plt.savefig(os.path.join(out_dir, f"{wsi_id}_heatmap_bar.png"), bbox_inches="tight", dpi=300)
    plt.clf()
    return True

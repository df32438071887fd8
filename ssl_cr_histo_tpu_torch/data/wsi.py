"""Whole-slide-image pyramid IO.

The port's own copy of ``ssl_cr_histo_tpu/data/wsi.py`` (numpy and cv2 only),
so that the port imports nothing of the JAX package.

A small reader protocol with three backends:

  * ``OpenSlideReader`` — real .tif/.svs WSIs via libopenslide (gated import;
    not present in this image, used in production deployments).
  * ``ArrayPyramid``    — an in-memory pyramid built from a level-0 array by
    repeated 2x downsampling; OpenSlide-compatible ``read_region`` semantics
    (location in LEVEL-0 coordinates).  Backs synthetic fixtures and .npy
    slides.
  * ``synthetic_wsi``   — procedural H&E-like slides for tests/benchmarks.

Replaces the reference's direct ``openslide.OpenSlide`` calls scattered
through ``dataset.py`` (e.g. dataset.py:322-384, :958-978) with a seam the
sampler and heatmap pipelines share.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Protocol, Tuple

import cv2
import numpy as np

try:  # pragma: no cover - not present in this image
    import openslide  # type: ignore

    HAS_OPENSLIDE = True
except ImportError:
    openslide = None
    HAS_OPENSLIDE = False


class PyramidReader(Protocol):
    """OpenSlide-shaped pyramid access."""

    @property
    def level_count(self) -> int: ...

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]: ...  # (w, h) per level

    @property
    def level_downsamples(self) -> List[float]: ...

    @property
    def mpp_x(self) -> float: ...

    def read_region(self, location, level, size) -> np.ndarray:
        """location: (x, y) in LEVEL-0 coordinates; size: (w, h) at ``level``.
        Returns uint8 RGB (h, w, 3); out-of-bounds area is white (tissue
        background), unlike OpenSlide's transparent-black — the samplers only
        read in-bounds."""
        ...


def _crop_pad_white(arr: np.ndarray, lx: int, ly: int, w: int, h: int) -> np.ndarray:
    """Crop ``arr[ly:ly+h, lx:lx+w]``; out-of-bounds area filled white (the
    tissue-background convention in the reader protocol docstring).  Shared
    by the array-backed backends so the boundary math cannot diverge."""
    out = np.full((h, w, 3), 255, np.uint8)
    sy0, sy1 = max(ly, 0), min(ly + h, arr.shape[0])
    sx0, sx1 = max(lx, 0), min(lx + w, arr.shape[1])
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - ly : sy1 - ly, sx0 - lx : sx1 - lx] = arr[sy0:sy1, sx0:sx1]
    return out


class ArrayPyramid:
    """In-memory pyramid with OpenSlide read_region semantics."""

    def __init__(self, level0: np.ndarray, levels: int = 4, mpp_x: float = 0.5):
        assert level0.dtype == np.uint8 and level0.ndim == 3
        self._levels = [level0]
        for _ in range(levels - 1):
            prev = self._levels[-1]
            h, w = prev.shape[:2]
            self._levels.append(
                cv2.resize(prev, (max(w // 2, 1), max(h // 2, 1)), interpolation=cv2.INTER_AREA)
            )
        self._mpp = mpp_x

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return [(a.shape[1], a.shape[0]) for a in self._levels]

    @property
    def level_downsamples(self) -> List[float]:
        w0 = self._levels[0].shape[1]
        return [w0 / a.shape[1] for a in self._levels]

    @property
    def mpp_x(self) -> float:
        return self._mpp

    def read_region(self, location, level, size) -> np.ndarray:
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        ds = self.level_downsamples[level]
        lx, ly = int(x0 / ds), int(y0 / ds)
        return _crop_pad_white(self._levels[level], lx, ly, w, h)


class OpenSlideReader:  # pragma: no cover - requires libopenslide
    """Thin adapter over openslide.OpenSlide."""

    def __init__(self, path: str):
        if not HAS_OPENSLIDE:
            raise ImportError(
                "openslide-python is not installed; use ArrayPyramid/.npy slides "
                "or install libopenslide for real WSI files"
            )
        self._slide = openslide.OpenSlide(path)

    @property
    def level_count(self) -> int:
        return self._slide.level_count

    @property
    def level_dimensions(self):
        return list(self._slide.level_dimensions)

    @property
    def level_downsamples(self):
        return list(self._slide.level_downsamples)

    @property
    def mpp_x(self) -> float:
        return float(self._slide.properties.get("openslide.mpp-x", 0.5))

    def read_region(self, location, level, size) -> np.ndarray:
        img = self._slide.read_region(location, level, size).convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    def close(self) -> None:
        self._slide.close()


def synthetic_wsi(
    width: int = 2048,
    height: int = 2048,
    n_blobs: int = 60,
    seed: int = 0,
    levels: int = 4,
    mpp_x: float = 0.5,
) -> ArrayPyramid:
    """Procedural H&E-like slide: white background, pink stroma regions with
    purple nuclei blobs — enough structure for foreground detection and
    augmentation to behave realistically."""
    rng = np.random.default_rng(seed)
    img = np.full((height, width, 3), 242, np.uint8)
    # large stroma regions (eosin pink)
    for _ in range(n_blobs // 4):
        cx, cy = rng.integers(0, width), rng.integers(0, height)
        ax, ay = rng.integers(width // 16, width // 4, 2)
        color = np.array([228, 160, 200]) + rng.normal(0, 8, 3)
        cv2.ellipse(
            img, (int(cx), int(cy)), (int(ax), int(ay)),
            float(rng.uniform(0, 180)), 0, 360,
            tuple(int(c) for c in np.clip(color, 0, 255)), -1,
        )
    # nuclei (haematoxylin purple)
    for _ in range(n_blobs * 20):
        cx, cy = rng.integers(0, width), rng.integers(0, height)
        r = int(rng.integers(3, 12))
        color = np.array([110, 60, 150]) + rng.normal(0, 15, 3)
        cv2.circle(img, (int(cx), int(cy)), r, tuple(int(c) for c in np.clip(color, 0, 255)), -1)
    return ArrayPyramid(img, levels=levels, mpp_x=mpp_x)


class PILTiffReader:
    """Multi-page pyramidal TIFF reader via PIL (no libopenslide needed).

    Pages must be a descending-resolution pyramid (the common pyramidal-TIFF
    layout).  Pages are decoded lazily and cached per level; suitable for
    test fixtures and small-to-medium slides — production WSI IO should use
    OpenSlideReader.

    Thread safety: the shared PIL handle is only touched under ``_lock``
    (PIL seek/convert mutates the Image object), so one reader may be shared
    across IO threads (e.g. the heatmap pipeline's pool) — decodes
    serialize, but reads of the cached level arrays run fully parallel.
    For parallel DECODE across threads, give each worker its own reader
    (``data.sampler`` does)."""

    def __init__(self, path: str, mpp_x: float = 0.5):
        import threading

        from PIL import Image

        self._lock = threading.Lock()
        self._img = Image.open(path)
        self._n = getattr(self._img, "n_frames", 1)
        dims = []
        for i in range(self._n):
            self._img.seek(i)
            dims.append(self._img.size)  # (w, h)
        # enforce descending order
        if any(dims[i][0] < dims[i + 1][0] for i in range(len(dims) - 1)):
            raise ValueError(f"{path}: TIFF pages are not a descending pyramid")
        self._dims = dims
        self._cache: dict = {}
        self._mpp = mpp_x

    @property
    def level_count(self) -> int:
        return self._n

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return list(self._dims)

    @property
    def level_downsamples(self) -> List[float]:
        w0 = self._dims[0][0]
        return [w0 / w for (w, h) in self._dims]

    @property
    def mpp_x(self) -> float:
        return self._mpp

    def _level(self, i: int) -> np.ndarray:
        arr = self._cache.get(i)
        if arr is None:
            with self._lock:  # seek/convert mutate the shared PIL handle
                arr = self._cache.get(i)
                if arr is None:
                    self._img.seek(i)
                    arr = np.asarray(self._img.convert("RGB"), dtype=np.uint8)
                    self._cache[i] = arr
        return arr

    def read_region(self, location, level, size) -> np.ndarray:
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        ds = self.level_downsamples[level]
        lx, ly = int(x0 / ds), int(y0 / ds)
        return _crop_pad_white(self._level(level), lx, ly, w, h)

    def close(self) -> None:
        with self._lock:
            self._img.close()
            self._cache.clear()


class ReaderCache:
    """LRU cache of open slide readers.

    The pretrain loop touches every slide every epoch; an unbounded readers
    dict keeps every slide's file descriptor (and, for the PIL backend, its
    decoded pages) open for the whole run — unbounded growth on TIGER-scale
    slide sets.  This caps the number of simultaneously open slides and
    ``close()``s evicted readers.
    """

    def __init__(self, capacity: int = 64, opener=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._opener = opener or open_slide
        self._readers: "OrderedDict[str, PyramidReader]" = OrderedDict()

    def get(self, path: str) -> PyramidReader:
        if path in self._readers:
            self._readers.move_to_end(path)
            return self._readers[path]
        reader = self._opener(path)
        self._readers[path] = reader
        while len(self._readers) > self.capacity:
            _, old = self._readers.popitem(last=False)
            close = getattr(old, "close", None)
            if close is not None:
                close()
        return reader

    def __len__(self) -> int:
        return len(self._readers)

    def close(self) -> None:
        for reader in self._readers.values():
            close = getattr(reader, "close", None)
            if close is not None:
                close()
        self._readers.clear()


def open_slide(path: str, levels: int = 4) -> PyramidReader:
    """Open a slide file: .npy -> ArrayPyramid; .tif -> OpenSlide when
    available else the PIL pyramidal-TIFF reader; anything else ->
    OpenSlide."""
    if path.endswith(".npy"):
        return ArrayPyramid(np.load(path), levels=levels)
    if path.endswith((".tif", ".tiff")) and not HAS_OPENSLIDE:
        return PILTiffReader(path)
    return OpenSlideReader(path)

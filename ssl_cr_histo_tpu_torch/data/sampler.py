"""RSP multi-resolution triplet sampling from WSI pyramids.

The port's own copy of ``ssl_cr_histo_tpu/data/sampler.py`` (numpy and cv2
only; cv2 imported where it is used), so that the port imports nothing of
the JAX package;
``tests/test_torch_data.py`` holds the two to equal output.

Re-implements the reference tile samplers with exact coordinate math but a
lazy, streaming design:

  * v1 geometry (reference ``dataset.py:322-384``): the LR1/HR tiles START at
    the level-0 projection of the LR2 tile's center (grid quantized to each
    level's downsample).
  * v2 geometry (reference ``Pretraining_v2/dataset.py:219-266``): the
    LR1/HR tiles are CENTERED on the LR2 tile's center.
  * v1 foreground: LAB a-channel > (1+0.15)*mu on >=95% of pixels, with mu
    the thumbnail mean (reference ``util.py:18-23``).
  * v2 foreground: HSV saturation > 0.1 on >=75% of pixels
    (``Pretraining_v2/util.py:9-13``).

Unlike the reference — which eagerly materializes every tile of every WSI in
RAM before training (``dataset.py:279-320``) — the sampler builds a light
coordinate index per slide and reads triplets on demand, so arbitrarily
large slide sets stream through the host->device pipeline.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ssl_cr_histo_tpu_torch.data.wsi import PyramidReader, open_slide


def foreground_lab(tile_u8: np.ndarray, mu: float, mu_percent: float = 0.15, thresh: float = 0.95) -> bool:
    """v1 tissue test on a uint8 RGB tile (reference util.py:18-23)."""
    import cv2

    lab = cv2.cvtColor(tile_u8, cv2.COLOR_RGB2LAB).astype(np.float32)
    a = lab[..., 1] - 128.0  # cv2 uint8 Lab stores a+128
    mask = a > (1.0 + mu_percent) * mu
    return mask.mean() >= thresh


def foreground_hsv(tile_u8: np.ndarray, sat_thresh: float = 0.1, thresh: float = 0.75) -> bool:
    """v2 tissue test (Pretraining_v2/util.py:9-13)."""
    import cv2

    hsv = cv2.cvtColor(tile_u8, cv2.COLOR_RGB2HSV)
    mask = hsv[..., 1].astype(np.float32) / 255.0 > sat_thresh
    return mask.mean() >= thresh


def slide_lab_mu(reader: PyramidReader, thumb_level: int | None = None) -> float:
    """Thumbnail mean of the LAB a-channel (reference dataset.py:400-403)."""
    import cv2

    level = thumb_level if thumb_level is not None else reader.level_count - 1
    w, h = reader.level_dimensions[level]
    thumb = reader.read_region((0, 0), level, (w, h))
    lab = cv2.cvtColor(thumb, cv2.COLOR_RGB2LAB).astype(np.float32)
    return float((lab[..., 1] - 128.0).mean())


@dataclass
class TripletIndex:
    """Per-slide work list of foreground grid positions (at the LR2 level)."""

    slide_path: str
    coords: np.ndarray  # (N, 2) int (x, y) at the LR2 level


class RSPTripletSampler:
    """Grid-scan a set of slides and read (HR, LR1, LR2) triplets.

    geometry: 'v1' (corner-at-center) or 'v2' (center-aligned).
    Levels are fixed (2, 1, 0) like the reference (dataset.py:277).
    """

    def __init__(
        self,
        tile: int = 256,
        stride: int = 128,
        geometry: str = "v1",
        check_mpp: bool = True,
        levels: Tuple[int, int, int] = (2, 1, 0),
        lwst_level_idx: int = 1,
    ):
        """lwst_level_idx: which level (counted from the bottom of the
        pyramid) supplies the foreground-statistics thumbnail — 1 for
        BreastPathQ, 5 for Camelyon16 (reference dataset.py:397-400,
        pretrain_Camelyon16.py's --lwst_level_idx)."""
        self.tile = tile
        self.stride = stride
        self.geometry = geometry
        self.check_mpp = check_mpp and geometry == "v1"  # v2 drops the check
        self.lr2, self.lr1, self.hr = levels
        self.lwst_level_idx = lwst_level_idx

    # -- index construction ------------------------------------------------

    def index_slide(self, reader: PyramidReader, slide_path: str = "") -> TripletIndex:
        if reader.level_count < 3:
            return TripletIndex(slide_path, np.zeros((0, 2), np.int64))
        if self.check_mpp:
            pixel_scale = np.uint8(np.round(0.5 / reader.mpp_x))
            if pixel_scale < 1:
                return TripletIndex(slide_path, np.zeros((0, 2), np.int64))

        # clamp to a valid level: the reference indexes level_count - idx
        # directly and crashes on idx outside [1, level_count]
        # (dataset.py:400); we clamp both ends instead
        thumb_level = min(
            max(reader.level_count - self.lwst_level_idx, 0),
            reader.level_count - 1,
        )
        mu = slide_lab_mu(reader, thumb_level) if self.geometry == "v1" else 0.0
        iw, ih = reader.level_dimensions[self.lr2]
        t, s = self.tile, self.stride
        m = reader.level_downsamples[self.lr2]
        fg = (
            (lambda tile_img: foreground_lab(tile_img, mu))
            if self.geometry == "v1"
            else foreground_hsv
        )
        coords = []
        # The reference grids [stride, dim-1-tile) in LR2-level units
        # (dataset.py:424-436).
        for ypos in range(s, ih - 1 - t, s):
            for xpos in range(s, iw - 1 - t, s):
                tile_img = reader.read_region(
                    (int(m * xpos), int(m * ypos)), self.lr2, (t, t)
                )
                if fg(tile_img):
                    coords.append((xpos, ypos))
        return TripletIndex(slide_path, np.asarray(coords, np.int64).reshape(-1, 2))

    def _cache_key(self, path: str) -> str:
        """Digest of (slide identity, sampling geometry): any change to the
        file or to tile/stride/geometry/lwst_level_idx invalidates."""
        import hashlib

        st = os.stat(path)
        payload = "|".join(
            str(v) for v in (
                os.path.abspath(path), st.st_mtime_ns, st.st_size,
                self.tile, self.stride, self.geometry, self.lwst_level_idx,
                self.check_mpp, self.lr2, self.lr1, self.hr,
            )
        )
        return hashlib.sha1(payload.encode()).hexdigest()

    def index_directory(
        self,
        image_dir: str,
        exts: Sequence[str] = ("tif", "svs", "npy"),
        cache_dir: "str | None" = "auto",
        n_workers: int = 0,
    ) -> List[TripletIndex]:
        """Index every slide under ``image_dir``, with a persistent on-disk
        coordinate cache and a slide-level thread pool.

        The reference re-scans every grid tile of every slide serially at
        each startup (dataset.py:424-436 inside the Dataset constructor) —
        hours of foreground testing on Camelyon16-scale sets before step 1.
        Here each slide's foreground scan result persists as an .npz keyed
        by (path, mtime, size, tile, stride, geometry, lwst_level_idx), so
        re-runs skip the scan entirely, and cold scans run one slide per
        thread (readers are per-thread — PIL/TIFF handles are not
        thread-safe to share).

        cache_dir: "auto" -> ``<image_dir>/.rsp_index`` (falls back to
        ``~/.cache/ssl_cr_histo_tpu_torch/rsp_index`` if unwritable); None/""
        disables caching.  n_workers: 0 -> min(8, cpu count).
        """
        from concurrent.futures import ThreadPoolExecutor

        paths: List[str] = []
        for ext in exts:
            paths += glob.glob(os.path.join(image_dir, f"*.{ext}"))
        paths = sorted(paths)

        if cache_dir == "auto":
            cache_dir = os.path.join(image_dir, ".rsp_index")
        if cache_dir:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                # one probe a process: the processes of a data-parallel
                # run index at once
                probe = os.path.join(cache_dir, f".w{os.getpid()}")
                with open(probe, "w"):
                    pass
                os.remove(probe)
            except OSError:
                # the cache is a best-effort optimization — if the fallback
                # location is unwritable too, run without it
                try:
                    cache_dir = os.path.expanduser(
                        "~/.cache/ssl_cr_histo_tpu_torch/rsp_index"
                    )
                    os.makedirs(cache_dir, exist_ok=True)
                except OSError:
                    cache_dir = None

        def one(p: str) -> TripletIndex:
            cpath = (
                os.path.join(cache_dir, self._cache_key(p) + ".npz")
                if cache_dir else None
            )
            if cpath and os.path.exists(cpath):
                with np.load(cpath) as z:
                    return TripletIndex(p, z["coords"])
            idx = self.index_slide(open_slide(p), p)
            if cpath:
                # best-effort write: a full disk or revoked permission must
                # not abort an hours-long cold scan
                import tempfile

                tmp = None
                try:
                    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npz")
                    with os.fdopen(fd, "wb") as f:
                        np.savez(f, coords=idx.coords)
                    os.replace(tmp, cpath)
                except OSError:
                    if tmp is not None and os.path.exists(tmp):
                        try:
                            os.remove(tmp)
                        except OSError:
                            pass
            return idx

        n_workers = n_workers or min(8, os.cpu_count() or 1)
        if n_workers > 1 and len(paths) > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                out = list(ex.map(one, paths))
        else:
            out = [one(p) for p in paths]
        # empty slides stay in the cache (so they skip re-scans) but drop
        # out of the returned work list
        return [i for i in out if len(i.coords)]

    # -- triplet reads -----------------------------------------------------

    def dump_triplet_pngs(self, triplet: np.ndarray, out_dir: str, slide_name: str, patch_id: int) -> None:
        """Optional visualization dump matching the reference's per-tile PNG
        output layout (reference dataset.py:328-332: {out}/{slide}/{id}/
        {hr,lr1,lr2}/{id}.png)."""
        from PIL import Image

        for name, img in zip(("hr", "lr1", "lr2"), triplet):
            d = os.path.join(out_dir, slide_name, str(patch_id), name)
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img).save(os.path.join(d, f"{patch_id}.png"))

    def read_triplet(self, reader: PyramidReader, x: int, y: int) -> np.ndarray:
        """Read one (3, tile, tile, 3) uint8 triplet [HR, LR1, LR2] at LR2
        grid position (x, y)."""
        t = self.tile
        m = reader.level_downsamples[self.lr2]
        lr2 = reader.read_region((int(m * x), int(m * y)), self.lr2, (t, t))

        def origin(level: int) -> Tuple[int, int]:
            ml = reader.level_downsamples[level]
            cx0 = int(m * (x + t / 2))  # level-0 coords of the LR2 center
            cy0 = int(m * (y + t / 2))
            if self.geometry == "v1":
                # corner at the center point, quantized (dataset.py:350-351)
                return int(int(cx0 / ml) * ml), int(int(cy0 / ml) * ml)
            # v2: tile centered on the center point
            # (Pretraining_v2/dataset.py:242-255)
            return (
                int((int(cx0 / ml) - t // 2) * ml),
                int((int(cy0 / ml) - t // 2) * ml),
            )

        lx1, ly1 = origin(self.lr1)
        lr1 = reader.read_region((lx1, ly1), self.lr1, (t, t))
        lxh, lyh = origin(self.hr)
        hr = reader.read_region((lxh, lyh), self.hr, (t, t))
        return np.stack([hr, lr1, lr2])

    def iter_batches(
        self,
        indices: Sequence[TripletIndex],
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
        readers=None,
        expand_orderings: bool = False,
        tile_cache=None,
        read_workers: int = 0,
    ) -> Iterator[np.ndarray]:
        """Shuffle the global work list and yield (B, 3, t, t, 3) uint8
        batches, opening each slide once.

        readers: a ``wsi.ReaderCache`` (preferred — LRU-capped open slides)
        or a plain dict; pass the same object across epochs to reuse
        handles.

        expand_orderings: strict reference epoch semantics — every triplet
        appears 6 times per epoch, once per resolution-sequence ordering
        (the reference's eager x6 dataset expansion, dataset.py:27-70),
        shuffled across the epoch; yields (tiles, labels) tuples with the
        (B,) int32 ordering labels for the step to apply verbatim.

        tile_cache: a dict kept across epochs caches each (path, x, y)
        triplet in host RAM after its first read — the reference's
        all-in-RAM behavior (dataset.py:279-320), opt-in here because it
        costs ~590 KB per 256^2 position.  With --expand_orderings it also
        collapses the 6x re-reads to one.

        read_workers > 1: read the next batch's triplets on a thread pool;
        each worker thread opens its OWN readers (a shared PILTiffReader is
        lock-protected but serializes page decodes), so per-thread reader
        RAM is duplicated — worth it on multi-core hosts where decode/IO
        dominates."""
        from ssl_cr_histo_tpu_torch.data.wsi import ReaderCache

        own_readers = readers is None
        if own_readers:
            readers = ReaderCache()

        def get_reader(path: str):
            if isinstance(readers, ReaderCache):
                return readers.get(path)
            if path not in readers:
                readers[path] = open_slide(path)
            return readers[path]

        import threading

        tl = threading.local()
        worker_caches: list = []
        worker_caches_lock = threading.Lock()

        def fetch(item) -> np.ndarray:
            key3 = (item[0], item[1], item[2])
            if tile_cache is not None:
                hit = tile_cache.get(key3)
                if hit is not None:
                    return hit
            if read_workers > 1:
                rc = getattr(tl, "readers", None)
                if rc is None:
                    rc = tl.readers = ReaderCache()
                    with worker_caches_lock:
                        worker_caches.append(rc)
                t = self.read_triplet(rc.get(item[0]), item[1], item[2])
            else:
                t = self.read_triplet(get_reader(item[0]), item[1], item[2])
            if tile_cache is not None:
                tile_cache[key3] = t
            return t

        work = [
            (idx.slide_path, int(x), int(y))
            for idx in indices
            for x, y in idx.coords
        ]
        if expand_orderings:
            work = [(p, x, y, lab) for p, x, y in work for lab in range(6)]
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(work))
        pool = None
        if read_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=read_workers)
        try:
            n = len(order)
            end = n - (n % batch_size) if drop_last else n
            for i0 in range(0, end, batch_size):
                sel = [work[i] for i in order[i0 : i0 + batch_size]]
                if pool is not None:
                    tiles = list(pool.map(fetch, sel))
                else:
                    tiles = [fetch(item) for item in sel]
                if expand_orderings:
                    labels = np.asarray([item[3] for item in sel], np.int32)
                    yield np.stack(tiles), labels
                else:
                    yield np.stack(tiles)
        finally:
            if pool is not None:
                # wait, then close the per-thread readers — shutdown alone
                # would strand their open slide handles until thread GC
                pool.shutdown(wait=True)
                for rc in worker_caches:
                    rc.close()
            if own_readers:
                # the default cache was created here; a caller-passed one
                # stays open (it is shared across epochs)
                readers.close()

"""The port's own copy of the slide sampler (``ssl_cr_histo_tpu_torch/data``)
against the JAX package's ``data.sampler`` / ``data.wsi`` it was copied
from: the same slides and seed give the same index and the same batches,
bit for bit."""

import os

import numpy as np
import pytest

from ssl_cr_histo_tpu.data import sampler as JS
from ssl_cr_histo_tpu.data import wsi as JW
from ssl_cr_histo_tpu_torch import data as TD
from ssl_cr_histo_tpu_torch.data import sampler as TS
from ssl_cr_histo_tpu_torch.data import wsi as TW


def _write_slides(d):
    """Two .npy slides whose tissue passes the v1 LAB foreground test at
    64^2, as tests/test_torch_pretrain_step.py writes them."""
    rng = np.random.default_rng(0)
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((1536, 1536, 3), 245, np.uint8)
        tissue = np.stack([np.full((1024, 1024), c) for c in (190, 80, 160)], axis=-1)
        level0[64:1088, 64:1088] = np.clip(tissue + rng.integers(-20, 20, tissue.shape), 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)


def test_port_exports_its_own_sampler():
    assert TD.RSPTripletSampler is TS.RSPTripletSampler and TD.TripletIndex is TS.TripletIndex
    assert TD.ReaderCache is TW.ReaderCache
    assert TS.RSPTripletSampler is not JS.RSPTripletSampler


@pytest.mark.parametrize("read_workers", [0, 2])
def test_sampler_copy_matches_jax_package(tmp_path, read_workers):
    """Index (slide paths and coordinates) and the first 3 batches of 4
    triplets at 64^2, seed 7, equal bit for bit, with the serial and the
    threaded reader."""
    slides = str(tmp_path / "wsis")
    _write_slides(slides)
    kw = dict(tile=64, stride=32)
    j_sampler, t_sampler = JS.RSPTripletSampler(**kw), TS.RSPTripletSampler(**kw)
    j_index = j_sampler.index_directory(slides, cache_dir=None)
    t_index = t_sampler.index_directory(slides, cache_dir=None)
    assert len(t_index) == len(j_index) == 2
    for a, b in zip(t_index, j_index):
        assert a.slide_path == b.slide_path
        assert len(a.coords) > 12
        np.testing.assert_array_equal(a.coords, b.coords)

    j_it = j_sampler.iter_batches(j_index, 4, seed=7, readers=JW.ReaderCache(), read_workers=read_workers)
    t_it = t_sampler.iter_batches(t_index, 4, seed=7, readers=TW.ReaderCache(), read_workers=read_workers)
    for _ in range(3):
        got, want = next(t_it), next(j_it)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (4, 3, 64, 64, 3)
        np.testing.assert_array_equal(got, want)
    t_it.close()
    j_it.close()

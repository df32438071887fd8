"""Host data plumbing: slide reading (``wsi``), triplet sampling
(``sampler``) and the host-to-device feed (``pipeline``).  ``wsi`` and
``sampler`` are the port's own copies of the JAX package's numpy/cv2-only
modules of the same names, so the port imports nothing of that package."""

from ssl_cr_histo_tpu_torch.data.sampler import RSPTripletSampler, TripletIndex
from ssl_cr_histo_tpu_torch.data.wsi import ReaderCache

__all__ = ["RSPTripletSampler", "TripletIndex", "ReaderCache"]

"""Host data plumbing.  Slide reading and triplet sampling are the JAX
package's framework-neutral modules (``ssl_cr_histo_tpu.data.wsi`` and
``ssl_cr_histo_tpu.data.sampler``: numpy and cv2 only), re-exported here so
that the port's callers import them from the port."""

from ssl_cr_histo_tpu.data.sampler import RSPTripletSampler, TripletIndex
from ssl_cr_histo_tpu.data.wsi import ReaderCache

__all__ = ["RSPTripletSampler", "TripletIndex", "ReaderCache"]

"""PyTorch / CUDA port of ``ssl_cr_histo_tpu`` for NVIDIA Hopper GPUs.

The subpackages mirror the JAX package's (``ops``, ``models``, ``parallel``,
``train``, ``data``, ``eval``, ``cli``) so each module's counterpart has the
same name.  The JAX package stays the reference the port is tested against;
this package imports ``torch`` and never ``jax``, and nothing of the JAX
package: the framework-neutral host modules it needs (``data.wsi``,
``data.sampler``, ``data.datasets``, ``eval.metrics``) are its own copies.
cv2, h5py, scipy and scikit-learn are imported inside the functions that use
them, so importing the package needs none of them.

Importing this package builds and loads nothing: hand-written CUDA kernels
(``csrc/``) are compiled at their first launch on a CUDA tensor.  It makes
one small CPU call, to set up MKL's vector math library on one thread (see
below).
"""

import torch

# PyTorch's CPU log, exp and the other elementwise functions it hands to
# MKL's vector math library run one library call per chunk of a parallel
# loop.  The library sets itself up on its first call; when several threads
# make that first call at once, one of them can compute its 2048-element
# chunk at reduced accuracy (log off by up to 4e-5 where it is exact to
# 1e-7), in about one fresh process in ten (tests/mkl_first_call_race.py).
# One call on a few elements, on this thread and below the loop's grain,
# sets the library up before any parallel call does.
torch.exp(torch.zeros(8))

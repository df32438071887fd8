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
(``csrc/``) are compiled at their first launch on a CUDA tensor.
"""

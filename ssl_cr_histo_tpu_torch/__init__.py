"""PyTorch / CUDA port of ``ssl_cr_histo_tpu`` for NVIDIA Hopper GPUs.

The subpackages mirror the JAX package's (``ops``, ``models``, ``parallel``,
``train``, ``data``, ``cli``) so each module's counterpart has the same name.
The JAX package stays the reference the port is tested against; this package
imports ``torch`` and never ``jax``.  The framework-neutral host modules of
the JAX package (``data.wsi``, ``data.sampler``, ``eval.metrics``: numpy and
cv2 only) are imported, not copied.

Importing this package builds and loads nothing: hand-written CUDA kernels
(``csrc/``) are compiled at their first launch on a CUDA tensor.
"""

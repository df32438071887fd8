"""Hand-written CUDA kernels (``*.cu``) and the builder that compiles them
with ``nvcc`` at first use (``build.py``)."""

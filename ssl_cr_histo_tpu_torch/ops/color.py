"""Stain matrices of the legacy scikit-image HED transform.

Counterpart of ``ssl_cr_histo_tpu/ops/color.py:23-31``: the same float32
values, computed the same way, so the photometric chain's HED stage matches
the JAX package bit for bit in its constants."""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston stain vectors (rows: H, E, DAB).
RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ],
    dtype=np.float32,
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED).astype(np.float32)

"""Augmentation ops on channel-planar (N, 3, H, W) float32 tiles in [0, 1].

The JAX package keeps tiles channels-last except on its kernel path; the port
is planar throughout because its photometric kernel and the first conv both
take NCHW."""

"""Evaluation: metrics (``metrics``), WSI heatmap serving (``heatmap``) and
the Camelyon16 FROC (``froc``); ``metrics`` and ``froc`` are the port's own
numpy copies of the JAX package's modules of the same names."""

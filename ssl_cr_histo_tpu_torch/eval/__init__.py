"""Evaluation: metrics (``metrics``), reporting plots (``reporting``), WSI
heatmap serving (``heatmap``) and the Camelyon16 FROC (``froc``);
``metrics``, ``reporting`` and ``froc`` are the port's own numpy copies of
the JAX package's modules of the same names."""

"""Evaluation: metrics (``metrics``), the port's own numpy copy of the JAX
package's module of the same name."""

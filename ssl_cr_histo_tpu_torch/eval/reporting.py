"""Reporting artifacts: t-SNE feature plots, confusion-matrix figures,
scatter and Bland-Altman plots -- the reference's visual outputs
(pretrain_BreastPathQ.py:322-340 t-SNE on best epoch; util.py:121-174
confusion-matrix plot; eval_BreastPathQ_SSL.py:504-544 scatter +
Bland-Altman).

The port's own copy of ``ssl_cr_histo_tpu/eval/reporting.py`` (numpy;
matplotlib and scikit-learn are imported inside the functions that draw, so
importing this module needs neither).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_tsne_plot(
    feats: np.ndarray,
    labels: np.ndarray,
    out_path: str,
    perplexity: float = 30.0,
    max_points: int = 5000,
    seed: int = 0,
) -> None:
    """2-D t-SNE of pretraining features colored by RSP class (reference
    pretrain_BreastPathQ.py:322-340).  Also saves the raw features/targets
    .npy next to the plot like the reference."""
    from sklearn.manifold import TSNE

    feats = np.asarray(feats)
    labels = np.asarray(labels)
    if len(feats) > max_points:
        idx = np.random.default_rng(seed).choice(len(feats), max_points, replace=False)
        feats, labels = feats[idx], labels[idx]
    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(len(feats) - 1, 1) / 3),
        random_state=seed, init="pca",
    ).fit_transform(feats)

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab10", s=6, alpha=0.7)
    fig.colorbar(sc, ax=ax)
    ax.set_title("t-SNE of RSP features")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    base = os.path.splitext(out_path)[0]
    np.save(base + "_feats.npy", feats)
    np.save(base + "_targets.npy", labels)


def save_confusion_matrix_plot(
    cm: np.ndarray,
    class_names: Sequence[str],
    out_path: str,
    normalize: bool = False,
    title: Optional[str] = None,
) -> None:
    """Annotated confusion-matrix figure (reference util.py:121-174)."""
    plt = _plt()
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set(
        xticks=np.arange(len(class_names)),
        yticks=np.arange(len(class_names)),
        xticklabels=class_names,
        yticklabels=class_names,
        ylabel="True label",
        xlabel="Predicted label",
        title=title or ("Normalized confusion matrix" if normalize else "Confusion matrix"),
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    thresh = cm.max() / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(
                j, i,
                f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}",
                ha="center", va="center",
                color="white" if cm[i, j] > thresh else "black",
            )
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)


def save_scatter_plot(x: np.ndarray, y: np.ndarray, xlabel: str, ylabel: str, out_path: str) -> None:
    """Prediction-vs-rater scatter with the identity line (reference
    eval_BreastPathQ_SSL.py:504-530)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.scatter(x, y, edgecolors=(0, 0, 0))
    lo, hi = float(np.min(x)), float(np.max(x))
    ax.plot([lo, hi], [lo, hi], "k--", lw=2)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def save_bland_altman_plot(a: np.ndarray, b: np.ndarray, out_path: str) -> None:
    """Mean-difference plot (statsmodels mean_diff_plot equivalent;
    reference eval_BreastPathQ_SSL.py:532-544)."""
    plt = _plt()
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mean = (a + b) / 2
    diff = a - b
    md, sd = diff.mean(), diff.std(ddof=1)
    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.scatter(mean, diff)
    for y, style in ((md, "-"), (md + 1.96 * sd, "--"), (md - 1.96 * sd, "--")):
        ax.axhline(y, color="gray", linestyle=style)
    ax.set_xlabel("Means")
    ax.set_ylabel("Difference")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close(fig)

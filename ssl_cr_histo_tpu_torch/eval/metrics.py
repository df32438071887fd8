"""Evaluation metrics: the port's own copy of
``ssl_cr_histo_tpu/eval/metrics.py`` (numpy; scipy is imported inside the
function that uses it).  Where the original calls scikit-learn (weighted F1,
the ROC-AUCs), this copy computes the same numbers in numpy, raising
ValueError where scikit-learn does, so that evaluation runs where
scikit-learn is not installed.

Covers everything the reference computes inline in its eval scripts:
  * ICC table (Shrout & Fleiss ICC1/2/3 and their k-rater forms) — the
    reference calls pingouin.intraclass_corr per rater pairing
    (eval_BreastPathQ_SSL.py:472-500); pingouin follows the same ANOVA
    formulas implemented here.
  * per-class sensitivity/specificity/accuracy + weighted F1 + confusion
    matrix (eval_Kather_SSL.py:516-537)
  * multiclass OVR ROC-AUC (eval_Kather_SSL_CR.py:658)
  * Bland-Altman statistics (statsmodels mean_diff_plot equivalent)
  * Kendall's tau (BreastPathQ challenge metric)
  * AverageMeter (reference util.py:26-46)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


class AverageMeter:
    """Running average tracker (reference util.py:26-46)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def icc_table(ratings: np.ndarray) -> Dict[str, float]:
    """Shrout & Fleiss ICCs for an (n_targets, k_raters) matrix.

    Returns ICC1, ICC2, ICC3 (single rater) and ICC1k/2k/3k (average of k),
    matching pingouin.intraclass_corr's six rows.
    """
    x = np.asarray(ratings, np.float64)
    n, k = x.shape
    mean_t = x.mean(axis=1, keepdims=True)
    mean_r = x.mean(axis=0, keepdims=True)
    grand = x.mean()

    ss_total = ((x - grand) ** 2).sum()
    ss_rows = k * ((mean_t - grand) ** 2).sum()  # between targets
    ss_cols = n * ((mean_r - grand) ** 2).sum()  # between raters
    ss_err = ss_total - ss_rows - ss_cols  # residual
    ss_within = ss_cols + ss_err

    ms_rows = ss_rows / (n - 1)
    ms_cols = ss_cols / (k - 1)
    ms_err = ss_err / ((n - 1) * (k - 1))
    ms_within = ss_within / (n * (k - 1))

    icc1 = (ms_rows - ms_within) / (ms_rows + (k - 1) * ms_within)
    icc2 = (ms_rows - ms_err) / (
        ms_rows + (k - 1) * ms_err + k * (ms_cols - ms_err) / n
    )
    icc3 = (ms_rows - ms_err) / (ms_rows + (k - 1) * ms_err)
    icc1k = (ms_rows - ms_within) / ms_rows
    icc2k = (ms_rows - ms_err) / (ms_rows + (ms_cols - ms_err) / n)
    icc3k = (ms_rows - ms_err) / ms_rows
    return {
        "ICC1": icc1,
        "ICC2": icc2,
        "ICC3": icc3,
        "ICC1k": icc1k,
        "ICC2k": icc2k,
        "ICC3k": icc3k,
    }


def icc_two_raters(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """ICC table for a prediction/target (or rater/rater) pairing — the
    reference's per-pairing pingouin call."""
    return icc_table(np.stack([np.asarray(a), np.asarray(b)], axis=1))


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    from scipy.stats import kendalltau

    return float(kendalltau(a, b).statistic)


@dataclass
class BlandAltman:
    mean_diff: float
    std_diff: float
    loa_low: float
    loa_high: float


def bland_altman(a: np.ndarray, b: np.ndarray) -> BlandAltman:
    """Mean-difference statistics behind statsmodels' mean_diff_plot."""
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    md, sd = diff.mean(), diff.std(ddof=1)
    return BlandAltman(md, sd, md - 1.96 * sd, md + 1.96 * sd)


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    for t, p in zip(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()):
        cm[int(t), int(p)] += 1
    return cm


def per_class_sens_spec_acc(cm: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class sensitivity/specificity/accuracy from a confusion matrix
    (the reference's Kather report, eval_Kather_SSL.py:519-533)."""
    cm = np.asarray(cm, np.float64)
    total = cm.sum()
    tp = np.diag(cm)
    fn = cm.sum(axis=1) - tp
    fp = cm.sum(axis=0) - tp
    tn = total - tp - fn - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        sens = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        spec = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        acc = (tp + tn) / total
    return {"sensitivity": sens, "specificity": spec, "accuracy": acc}


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """scikit-learn's ``f1_score(average='weighted')``: each label of either
    vector scores 2 tp / (true + predicted), weighted by its count in
    ``y_true`` (a label never true weighs 0; no true label at all gives 0)."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    labels = np.union1d(y_true, y_pred)
    true = np.array([np.sum(y_true == c) for c in labels], np.float64)
    pred = np.array([np.sum(y_pred == c) for c in labels], np.float64)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.float64)
    f1 = 2.0 * tp / np.maximum(true + pred, 1.0)
    return float(np.average(f1, weights=true)) if true.sum() else 0.0


def _midranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of ``x``, ties given the mean of their ranks."""
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    last = np.cumsum(counts)
    return ((last - counts + 1 + last) / 2.0)[inv.ravel()]


def binary_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC of ``scores`` for the greater of the two labels of ``y_true``
    (scikit-learn's ``roc_auc_score``): the Mann-Whitney statistic, ties
    counted one half, which is the area under the ROC curve's steps."""
    y, s = np.asarray(y_true).ravel(), np.asarray(scores, np.float64).ravel()
    classes = np.unique(y)
    if len(classes) != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in that case.")
    pos = y == classes[1]
    n_pos, n_neg = float(pos.sum()), float((~pos).sum())
    return float((_midranks(s)[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def multiclass_ovr_auc(y_true: np.ndarray, probs: np.ndarray) -> float:
    """One-vs-rest ROC-AUC, the mean over classes (reference
    eval_Kather_SSL_CR.py:658; scikit-learn's ``roc_auc_score(...,
    multi_class='ovr')``): ValueError unless each row of ``probs`` sums to 1
    and ``y_true`` holds one label per column."""
    y, probs = np.asarray(y_true).ravel(), np.asarray(probs)
    if not np.allclose(1, probs.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, i.e. they should sum up "
                         "to 1.0 over classes")
    classes = np.unique(y)
    if len(classes) != probs.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns in 'y_score'")
    return float(np.mean([binary_auc(y == c, probs[:, k]) for k, c in enumerate(classes)]))


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float((np.asarray(y_true) == np.asarray(y_pred)).mean())

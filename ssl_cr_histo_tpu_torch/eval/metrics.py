"""Evaluation metrics: the port's own copy of
``ssl_cr_histo_tpu/eval/metrics.py`` (numpy; scipy and scikit-learn are
imported inside the functions that use them).

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
    from sklearn.metrics import f1_score

    return float(f1_score(y_true, y_pred, average="weighted"))


def multiclass_ovr_auc(y_true: np.ndarray, probs: np.ndarray) -> float:
    """One-vs-rest ROC-AUC (reference eval_Kather_SSL_CR.py:658)."""
    from sklearn.metrics import roc_auc_score

    return float(roc_auc_score(y_true, probs, multi_class="ovr"))


def binary_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    from sklearn.metrics import roc_auc_score

    return float(roc_auc_score(y_true, scores))


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float((np.asarray(y_true) == np.asarray(y_pred)).mean())

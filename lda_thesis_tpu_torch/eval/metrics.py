"""Multilabel ranking metrics (NumPy, host side).

Copy of ``lda_thesis_tpu/eval/metrics.py`` (the reference's evaluation,
evaluate_LabeledLDA.py:8-107):

* per-document ROC sweep over the unique score values as thresholds,
  prediction = score >= threshold,
* macro AUC-ROC = mean over documents of the trapezoidal area over the
  (fpr, tpr) points,
* ``n_error(th, y, n)`` = fraction of documents whose top-n scores contain at
  least one true label (a hit rate, printed by the reference as "error"),
* macro max-F1: per document the maximum F1 over the threshold sweep.

Documents with fewer than 2 unique scores contribute NaN and are excluded
from the macro mean.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "one_roc",
    "rates",
    "macro_auc_roc",
    "n_error",
    "get_f1",
    "binary_yreal",
    "evaluate_ranking",
]


def one_roc(prob: np.ndarray, real_binary: np.ndarray):
    """Confusion counts for one document over its unique-score thresholds."""
    prob = np.asarray(prob, dtype=float)
    real = np.asarray(real_binary) > 0
    thresholds = np.unique(prob)[::-1]
    preds = prob[None, :] >= thresholds[:, None]  # (T, K)
    tp = (preds & real[None, :]).sum(axis=1)
    fp = (preds & ~real[None, :]).sum(axis=1)
    fn = (~preds & real[None, :]).sum(axis=1)
    tn = (~preds & ~real[None, :]).sum(axis=1)
    return tp, tn, fp, fn


def _fpr_tpr(tp, fp, tn, fn):
    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fp / (fp + tn)
        tpr = tp / (tp + fn)
    return fpr, tpr


def rates(y_prob: np.ndarray, y_real_binary: np.ndarray):
    """Per-document confusion-count series (reference ``rates``)."""
    tps, tns, fps, fns, fprs, tprs = [], [], [], [], [], []
    for d_prob, d_real in zip(y_prob, y_real_binary):
        tp, tn, fp, fn = one_roc(d_prob, d_real)
        fpr, tpr = _fpr_tpr(tp, fp, tn, fn)
        tps.append(tp)
        tns.append(tn)
        fps.append(fp)
        fns.append(fn)
        fprs.append(fpr)
        tprs.append(tpr)
    return tps, tns, fps, fns, fprs, tprs


def _trapezoid_auc(x: np.ndarray, y: np.ndarray) -> float:
    """sklearn.metrics.auc semantics: trapezoid over (x, y), any direction."""
    if len(x) < 2:
        return np.nan
    dx = np.diff(x)
    if np.all(dx >= 0) or np.all(dx <= 0):
        return float(abs(np.trapezoid(y, x)))
    raise ValueError("x is neither increasing nor decreasing")


def macro_auc_roc(fprs: Sequence[np.ndarray], tprs: Sequence[np.ndarray]) -> float:
    aucs = [_trapezoid_auc(fpr, tpr) for fpr, tpr in zip(fprs, tprs)]
    return float(np.nanmean(aucs))


def n_error(th_hat: np.ndarray, y_real_binary: np.ndarray, n: int) -> float:
    """Top-n hit rate (reference ``n_error``, evaluate_LabeledLDA.py:72-82)."""
    th_hat = np.asarray(th_hat)
    y = np.asarray(y_real_binary)
    # reference: np.argsort(row)[::-1][:n] — ties resolved identically
    top = np.argsort(th_hat, axis=1)[:, ::-1][:, :n]
    hits = np.take_along_axis(y, top, axis=1).sum(axis=1) > 0
    return float(hits.mean())


def get_f1(tps, fps, tns, fns) -> float:
    """Macro max-F1 over the per-document threshold sweeps."""
    f1s = []
    for tp, fp, tn, fn in zip(tps, fps, tns, fns):
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = tp / (tp + fp)
            rec = tp / (tp + fn)
            raw = 2 * prec * rec / (prec + rec)
        f1s.append(np.nanmax(raw) if np.any(np.isfinite(raw)) else np.nan)
    return float(np.nanmean(f1s))


def binary_yreal(
    label_strings: Sequence[Sequence[str]], label_dict: Dict[str, int]
) -> np.ndarray:
    """(D, K) binary truth matrix; unknown labels ignored (reference :96-107)."""
    y = np.zeros((len(label_strings), len(label_dict)), dtype=int)
    for d, lab in enumerate(label_strings):
        for l in lab:
            idx = label_dict.get(l)
            if idx is not None:
                y[d, idx] = 1
    return y


def evaluate_ranking(
    th_hat: np.ndarray, y_bin: np.ndarray
) -> Dict[str, float]:
    """AUC / 1-hit / 2-hit / macro-F1 bundle over pre-filtered matrices."""
    tps, tns, fps, fns, fprs, tprs = rates(th_hat, y_bin)
    return {
        "auc_roc": macro_auc_roc(fprs, tprs),
        "one_hit": n_error(th_hat, y_bin, 1),
        "two_hit": n_error(th_hat, y_bin, 2),
        "f1_macro": get_f1(tps, fps, tns, fns),
    }

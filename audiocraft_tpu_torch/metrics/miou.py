"""Mean intersection over union of binary localisation masks (counterpart
of `audiocraft_tpu/metrics/miou.py`)."""
import numpy as np


def calculate_miou(y_pred, y_true) -> float:
    """mIoU between [B, frames] arrays (numpy or tensors): a prediction is
    positive above 0.5, the truth where non-zero; a row whose union is
    empty has IoU 0."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    if y_pred.shape != y_true.shape:
        raise ValueError("Input tensors must have the same shape")
    y_pred = y_pred > 0.5
    y_true = y_true.astype(bool)
    intersection = np.logical_and(y_pred, y_true).sum(axis=1)
    union = np.logical_or(y_pred, y_true).sum(axis=1)
    return float((intersection / np.maximum(union, 1)).mean())

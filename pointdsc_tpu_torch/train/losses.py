"""Losses and metrics, masked and on the device (PyTorch counterpart of
``pointdsc_tpu/train/losses.py``).

Everything is branch-free and masked, so a padded batch is one computation,
and every result is a 0-d tensor: the host sees it only at logging time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointdsc_tpu_torch.ops.se3 import decompose_trans, transform


def _masked_mean(x, mask, dim=None, eps=1e-12):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / (torch.sum(m) + eps)
    return torch.sum(x * m, dim=dim) / (torch.sum(m, dim=dim) + eps)


def _log1p_exp_neg_abs(x):
    return torch.log1p(torch.exp(-torch.abs(x)))


def classification_loss(logits, gt_labels, mask=None, balanced: bool = False):
    """BCE with logits over correspondences. ``balanced`` weights positives
    by num_neg / num_pos over the whole masked batch (torch's ``pos_weight``
    form, with the reference's max(n - 1, 0) + 1 counts)."""
    if mask is None:
        mask = torch.ones_like(logits, dtype=torch.bool)
    m = mask.to(logits.dtype)
    gt = gt_labels.to(logits.dtype)
    soft = _log1p_exp_neg_abs(logits)
    if balanced:
        num_pos = torch.clamp(torch.sum(gt * m) - 1, min=0.0) + 1.0
        num_neg = torch.clamp(torch.sum((1 - gt) * m) - 1, min=0.0) + 1.0
        pos_weight = num_neg / num_pos
        log_sig = -(torch.clamp(-logits, min=0) + soft)
        log_one_minus = -(torch.clamp(logits, min=0) + soft)
        per = -(pos_weight * gt * log_sig + (1 - gt) * log_one_minus)
    else:
        per = torch.clamp(logits, min=0) - logits * gt + soft
    return _masked_mean(per, mask)


def classification_metrics(logits, gt_labels, mask=None) -> dict:
    """Inlier precision / recall / F1 and mean logits over all valid entries
    of the batch."""
    if mask is None:
        mask = torch.ones_like(logits, dtype=torch.bool)
    m = mask.to(logits.dtype)
    gt = gt_labels.to(logits.dtype)
    pred = (logits > 0).to(logits.dtype)

    tp = torch.sum(pred * gt * m)
    fp = torch.sum(pred * (1 - gt) * m)
    fn = torch.sum((1 - pred) * gt * m)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    logit_true = torch.sum(logits * gt * m) / torch.clamp(torch.sum(gt * m), min=1.0)
    logit_false = torch.sum(logits * (1 - gt) * m) / torch.clamp(torch.sum((1 - gt) * m), min=1.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "logit_true": logit_true, "logit_false": logit_false}


def spectral_matching_loss(M, gt_labels, mask=None, balanced: bool = True):
    """MSE between the feature-similarity matrix M [B, N, N] and the gt inlier
    outer product, diagonal excluded from the numerators. The diagonal stays
    in ``pair_mask``: M and gt_M are zero on it, but the reference counts its
    N entries in every denominator."""
    b, n = gt_labels.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=M.device)
    pair_mask = (mask[:, :, None] & mask[:, None, :]).to(M.dtype)
    gt = gt_labels.to(M.dtype)
    gt_M = gt[:, None, :] * gt[:, :, None]
    gt_M = gt_M * pair_mask * (1.0 - torch.eye(n, dtype=M.dtype, device=M.device))

    if balanced:
        sq_p = ((M - 1.0) ** 2) * gt_M
        sq_n = (M ** 2) * (1.0 - gt_M) * pair_mask
        denom_p = torch.clamp(torch.sum(gt_M, dim=(1, 2)) - 1.0, min=0.0) + 1.0
        denom_n = torch.clamp(torch.sum((1.0 - gt_M) * pair_mask, dim=(1, 2)) - 1.0,
                              min=0.0) + 1.0
        loss_p = torch.sum(sq_p, dim=(1, 2)) / denom_p
        loss_n = torch.sum(sq_n, dim=(1, 2)) / denom_n
        return torch.mean(0.5 * loss_p + 0.5 * loss_n)
    per = ((M - gt_M) ** 2) * pair_mask
    return torch.sum(per) / torch.clamp(torch.sum(pair_mask), min=1.0)


class TransformationLossOutput(NamedTuple):
    loss: torch.Tensor
    recall: torch.Tensor  # percentage in [0, 100]
    re: torch.Tensor  # degrees (batch mean)
    te: torch.Tensor  # centimetres (batch mean)
    rmse: torch.Tensor


def transformation_loss(trans, gt_trans, src_keypts, tgt_keypts, probs, mask=None,
                        re_thre: float = 15.0, te_thre: float = 30.0) -> TransformationLossOutput:
    """Transformation loss and registration metrics over the batch. The loss
    per sample is the mean squared residual of the warped correspondences,
    but only when a predicted inlier exists (probs > 0), else 0."""
    if mask is None:
        mask = torch.ones(src_keypts.shape[:2], dtype=torch.bool, device=src_keypts.device)

    R, t = decompose_trans(trans)
    gt_R, gt_t = decompose_trans(gt_trans)

    tr = torch.diagonal(R.transpose(-1, -2) @ gt_R, dim1=-2, dim2=-1).sum(-1)
    re = torch.rad2deg(torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))
    te = torch.sqrt(torch.sum((t - gt_t) ** 2, dim=(-2, -1))) * 100.0

    warped = transform(src_keypts, trans)
    resid_sq = torch.sum((warped - tgt_keypts) ** 2, dim=-1)  # [B, N]
    rmse = _masked_mean(torch.sqrt(resid_sq), mask, dim=-1)

    recall = torch.mean(((re < re_thre) & (te < te_thre)).float()) * 100.0

    has_inlier = torch.any((probs > 0) & mask, dim=-1)
    per_sample = _masked_mean(resid_sq, mask, dim=-1)
    loss = torch.mean(torch.where(has_inlier, per_sample, torch.zeros_like(per_sample)))

    return TransformationLossOutput(loss=loss, recall=recall, re=torch.mean(re),
                                    te=torch.mean(te), rmse=torch.mean(rmse))

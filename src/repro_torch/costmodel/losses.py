"""Loss functions for the cost model (paper §VI-D.3), on tensors.

The under-penalized RMSE (eq. 32) discounts under-predictions by ``alpha``:
over-predicted compute times hurt load balance more (an over-predicted task
makes CCM-LB leave real work behind), so the trained model "barely
over-predicts".
"""
from __future__ import annotations

import torch


def rmse(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(pred - truth)))


def mae(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - truth))


def under_penalized_rmse(pred: torch.Tensor, truth: torch.Tensor,
                         alpha: float = 0.3) -> torch.Tensor:
    """sqrt(mean e_i) with e_i = (g-p)^2 if g>=p else alpha*(g-p)^2 (eq. 32)."""
    err = pred - truth
    sq = torch.square(err)
    weighted = torch.where(err >= 0, sq, alpha * sq)
    return torch.sqrt(torch.mean(weighted))

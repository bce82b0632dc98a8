"""Cost-model training loop (paper §VI-D): mini-batch AdamW on the
under-penalized RMSE, with standard scaling and Algorithm-1 data reduction.
Targets are log-transformed (durations span orders of magnitude).

The port of ``repro/costmodel/train.py``: eager autograd in place of
``jax.jit`` + ``value_and_grad``, on the card unless the caller asks for the
CPU.  Mini-batches come from the same ``np.random.default_rng(seed)``
permutations as the reference's, so both see the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.costmodel.losses import mae, rmse, under_penalized_rmse
from repro_torch.costmodel.network import FNN, FNNConfig
from repro_torch.costmodel.reduction import dynamic_data_reduce
from repro_torch.costmodel.scaler import StandardScaler
from repro_torch.kernels.ccm_scorer.launch import resolve_device
from repro_torch.optim import AdamW


def _augment(features: np.ndarray) -> np.ndarray:
    """Append log1p features: task durations are ~log-linear in the raw
    counts (rows x cols x quad), so this makes the FNN's job easy."""
    return np.concatenate([features, np.log1p(np.abs(features))], axis=1)


@dataclasses.dataclass
class CostModel:
    cfg: FNNConfig
    net: FNN
    scaler: StandardScaler
    log_target: bool = True

    def predict(self, features: np.ndarray) -> np.ndarray:
        """float32 predictions (seconds), as the reference returns them."""
        dev = self.net.out_w.device
        x = torch.as_tensor(self.scaler.transform(_augment(features)),
                            dtype=torch.float32).to(dev)
        with torch.no_grad():
            pred = self.net(x, train=False).cpu().numpy()
        return np.exp(pred) if self.log_target else pred


def make_optimizer(net: FNN) -> AdamW:
    """The reference's training optimizer: constant lr 1e-3, decay 1e-4."""
    return AdamW(net.parameters(), 1e-3, weight_decay=1e-4)


def train_step(net: FNN, opt: AdamW, xb: torch.Tensor, yb: torch.Tensor,
               alpha: float,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step on a batch; returns the (detached) loss before the step."""
    loss = under_penalized_rmse(net(xb, train=True, generator=generator),
                                yb, alpha)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def train_cost_model(features: np.ndarray, durations: np.ndarray, *,
                     epochs: int = 60, batch_size: int = 256,
                     alpha: float = 0.3, reduce_to: Optional[int] = None,
                     seed: int = 0, log_target: bool = True,
                     hidden=(200, 200, 200, 200), dropout: float = 0.1,
                     device=None) -> Tuple[CostModel, Dict]:
    """Returns (model, history).  ``reduce_to`` applies Algorithm 1 first.
    ``device`` (``None`` means ``"cuda"``, which raises without a card)
    holds the network, the data and the training."""
    dev = resolve_device(device)
    features = np.asarray(features, np.float64)
    durations = np.asarray(durations, np.float64)
    if reduce_to is not None and reduce_to < features.shape[0]:
        keep = dynamic_data_reduce(durations, reduce_to, seed=seed)
        features, durations = features[keep], durations[keep]

    features = _augment(features)
    scaler = StandardScaler().fit(features)
    x = torch.as_tensor(scaler.transform(features), dtype=torch.float32)
    y = np.log(np.maximum(durations, 1e-12)) if log_target else durations
    x, y = x.to(dev), torch.as_tensor(y, dtype=torch.float32).to(dev)

    cfg = FNNConfig(in_dim=features.shape[1], hidden=tuple(hidden),
                    dropout=dropout)
    gen = torch.Generator(dev).manual_seed(seed)
    net = FNN(cfg, generator=gen, device=dev)
    opt = make_optimizer(net)

    n = x.shape[0]
    bs = min(batch_size, n)
    steps = max(n // bs, 1)
    history = {"loss": []}
    rng_np = np.random.default_rng(seed)
    for ep in range(epochs):
        perm = torch.from_numpy(rng_np.permutation(n)).to(dev)
        losses = []
        for s in range(steps):
            idx = perm[s * bs:(s + 1) * bs]
            losses.append(train_step(net, opt, x[idx], y[idx], alpha, gen))
        history["loss"].append(sum(torch.stack(losses).tolist()) / steps)
    return CostModel(cfg, net, scaler, log_target), history


def evaluate_cost_model(model: CostModel, features: np.ndarray,
                        durations: np.ndarray) -> Dict[str, float]:
    """Metrics in float32 on the host, as the reference computes them."""
    pred = model.predict(features)
    p = torch.as_tensor(pred, dtype=torch.float32)
    t = torch.as_tensor(durations, dtype=torch.float32)
    over = np.mean(pred >= durations)
    return {
        "rmse": float(rmse(p, t)),
        "mae": float(mae(p, t)),
        "under_rmse": float(under_penalized_rmse(p, t, 0.3)),
        "over_predict_frac": float(over),
        "rel_err_median": float(np.median(np.abs(pred - durations) /
                                          np.maximum(durations, 1e-12))),
    }

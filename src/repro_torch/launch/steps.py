"""Step builders, after the JAX package's ``launch/steps.py``: the train,
prefill and decode steps that the trainer and the server call.

One device holds the model, so there is no sharding and nothing to lower:
the reference's ``abstract_*``, ``named`` and ``lower_*`` serve its
multi-pod dry-run and wait for that slice (ROADMAP queue 1, item 7.7).
Parameters are a tree of tensors (``models.transformer.init_lm``'s layout);
``checkpoint.tree_leaves`` flattens it in the order that the optimizer and
the checkpoints share.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.checkpoint import tree_leaves
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine


def make_optimizer(params, *, lr=3e-4, warmup_steps=100,
                   total_steps=10000) -> AdamW:
    """AdamW over ``tree_leaves(params)`` (which it makes leaves that
    require grad) with the reference train step's schedule and its weight
    decay, 0.1."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return AdamW(leaves, warmup_cosine(lr, warmup_steps, total_steps),
                 weight_decay=0.1)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}


def make_train_step(model: Model):
    """``train_step(params, opt, batch) -> metrics``: the loss and its
    gradients, then one AdamW update of ``params`` in place (the port's
    counterpart of the reference's donated buffers).  The metrics hold the
    loss too; they are tensors on the model's device."""

    def train_step(params, opt: AdamW, batch) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        loss, metrics = model.loss_fn(params, to_device(batch, model.device))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill_fn(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, token, pos):
        with torch.inference_mode():
            return model.decode_fn(params, cache, token, pos)
    return decode_step

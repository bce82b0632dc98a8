"""Weights drawn from the seed on the device, in the types they are served
in, for both the program and the reference.

The layout (every leaf's name, shape and dtype) is the program's parameter
tree; the values are the benchmark's: one standard-normal draw a dtype, on
the device from a ``torch.Generator``, each leaf a view into it (offsets
aligned to 256 bytes) scaled in place by the rule below.  The same seed
gives the same values on any run, so the reference draws them again after
the window instead of keeping a copy."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN_BYTES = 256

#: (mean, std) of leaves by name: mixing coefficients in [0, 1], the RWKV6
#: decay's base near -6 (memories of some 20 to some 10^4 tokens), norm
#: weights as deltas around 1 (the rms norms) or around 1 and 0 (the group
#: norm), the bonus u
FIXED = {
    "mu_x": (0.5, 0.15), "mu": (0.5, 0.15), "mu_k": (0.5, 0.15),
    "mu_r": (0.5, 0.15), "w0": (-6.0, 1.0), "u": (0.0, 0.5),
    "ln_w": (1.0, 0.1), "ln_b": (0.0, 0.1), "norm_attn": (0.0, 0.1),
    "norm_mlp": (0.0, 0.1), "final_norm": (0.0, 0.1),
}
#: low-rank adapters: 0.1 / sqrt(fan in), the fan in on this axis
LORA_FAN_IN_AXIS = {"mix_a": 0, "w_a": 0, "mix_b": -2, "w_b": 0}


def fan_in(path: Tuple[str, ...], shape) -> int:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name == "embed":
        return shape[-1]
    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        return shape[1]
    if parent == "attn" and name == "w_o":
        return shape[0] * shape[1]
    return shape[0]


def rule(path: Tuple[str, ...], shape) -> Tuple[float, float]:
    """(mean, std) of the leaf at ``path``."""
    name = path[-1]
    if name in FIXED:
        return FIXED[name]
    if name in LORA_FAN_IN_AXIS:
        return 0.0, 0.1 / math.sqrt(shape[LORA_FAN_IN_AXIS[name]])
    if len(shape) < 2:
        return 0.0, 0.1
    return 0.0, 1.0 / math.sqrt(fan_in(path, shape))


def named_leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) of a tree of dicts and lists, in a fixed order (dict
    keys sorted, as the program's ``tree_leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _rebuild(tree, values: Dict[Tuple[str, ...], torch.Tensor], prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, values, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return values[prefix]


def draw(layout, seed: int, device) -> dict:
    """A tree shaped as ``layout`` (tensors, e.g. on ``meta``, giving each
    leaf's shape and dtype) holding the benchmark's weights for ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = named_leaves(layout)
    groups: Dict[torch.dtype, list] = {}
    for path, t in leaves:
        groups.setdefault(t.dtype, []).append((path, t))
    values = {}
    for dtype in sorted(groups, key=str):
        align = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        offsets, total = [], 0
        for _, t in groups[dtype]:
            offsets.append(total)
            total += -(-t.numel() // align) * align
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        for (path, t), off in zip(groups[dtype], offsets):
            view = flat[off:off + t.numel()].view(tuple(t.shape))
            mean, std = rule(path, tuple(t.shape))
            view.mul_(std)
            if mean:
                view.add_(mean)
            values[path] = view
    return _rebuild(layout, values)

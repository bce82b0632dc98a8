"""The precision the reference computes its products in.

``"fp32"``: float32 products with TF32 off (:func:`strict_float32`).
``"fp8"``, the control: each operand of a product that the configuration
keeps in bf16 is rounded to float8 e4m3 with a per-tensor scale, and each
operand of a product it keeps in float32 to bf16: the step below the
configuration's precision that would tempt a later change."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to the format's largest), back in ``x``'s dtype."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"Precision: {name!r}")
        self.name = name

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product the configuration keeps in bf16."""
        return x if self.name == "fp32" else to_e4m3(x)

    def high(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product the configuration keeps in float32."""
        return x if self.name == "fp32" else x.to(torch.bfloat16).to(x.dtype)

"""The reference's products: fp32 (the sound reference), or with every
operand of a convolution, linear layer, attention product or match
similarity rounded to fp8 e4m3 under a per-tensor scale, products summed in
fp32 (the control: the next precision below the configuration's bf16, as an
fp8 tensor-core product computes it). Norms, softmax, blends and the DDIM
or flow update stay fp32 in both."""

from __future__ import annotations

import torch
import torch.nn.functional as F

KINDS = ("fp32", "fp8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under one scale that maps its largest
    magnitude to FP8_MAX, returned in fp32."""
    t = t.float()
    amax = t.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in KINDS:
            raise ValueError(f"precision {kind!r} is not one of {KINDS}")
        self.kind = kind
        self._weights: dict[int, torch.Tensor] = {}

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t.float() if self.kind == "fp32" else fp8_round(t)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return w.float()
        key = id(w)
        if key not in self._weights:
            self._weights[key] = fp8_round(w)
        return self._weights[key]

    def linear(self, x: torch.Tensor, mod) -> torch.Tensor:
        bias = None if mod.bias is None else mod.bias.float()
        return F.linear(self.operand(x), self.weight(mod.weight), bias)

    def conv(self, x: torch.Tensor, mod) -> torch.Tensor:
        bias = None if mod.bias is None else mod.bias.float()
        return F.conv2d(self.operand(x), self.weight(mod.weight), bias, mod.stride,
                        mod.padding)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))

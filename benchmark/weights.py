"""Random weights for a model, made on the device from the run's seed in a
few large calls, in the dtype they are served in: one normal draw for all
of a model's parameters, split into views under its state-dict names and
scaled per tensor (a weight of fan-in n by 1 / sqrt(n), a bias by 0.1; a
norm's scale is 1 + 0.1 z). The program and the reference are both handed
this state dict."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

BIAS_STD = 0.1
NORM_STD = 0.1


def sub_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    return int(np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)[0] >> 1)


def random_state_dict(shapes: nn.Module, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """Weights for every parameter of ``shapes`` (a model on the meta device
    under the state-dict names)."""
    named = [(n, tuple(p.shape)) for n, p in shapes.named_parameters()]
    sizes = [math.prod(s) for _, s in named]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    views = [v.view(s) for v, (_, s) in zip(flat.split(sizes), named)]
    scales, norms = [], []
    for (name, shape), v in zip(named, views):
        if len(shape) >= 2:
            scales.append(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("bias"):
            scales.append(BIAS_STD)
        else:  # a norm's scale
            scales.append(NORM_STD)
            norms.append(v)
    torch._foreach_mul_(views, scales)
    if norms:
        torch._foreach_add_(norms, 1.0)
    return {name: v for (name, _), v in zip(named, views)}

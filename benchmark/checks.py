"""How ``correct`` is decided: which of the window's steps are compared, and
the numbers compared for each, against the cell's limits
(``limits/<cell>.json``)."""

from __future__ import annotations

import math
import random

import torch


class Sample:
    """The window's first step, and ``size`` of the later ones drawn
    uniformly from those run (reservoir sampling from the run's seed), each
    with the state it started from and the one it produced."""

    def __init__(self, seed: int, size: int = 1):
        self.rng = random.Random(seed)
        self.size = size
        self.first = None
        self.later: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.first is None:
            self.first = item
            return
        self.seen += 1
        if len(self.later) < self.size:
            self.later.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.later[j] = item

    def items(self) -> list:
        return ([] if self.first is None else [self.first]) + sorted(self.later,
                                                                     key=lambda it: it[0])


def step_numbers(x_out: torch.Tensor, x_ref: torch.Tensor, x_in=None) -> dict:
    """The program's state after a step against the reference's from the
    same state before it: the relative L2 gap over the whole latent
    (``state_rel_l2``) and in the worst frame (``frame_rel_l2``). Given the
    state before, ``x_in`` (a flow step's), also the gap of the step's
    increment x_out - x_in against the reference's x_ref - x_in over the
    whole latent (``step_rel_l2``): a flow step moves the state by a small
    share of the guided velocity, and its increment is that velocity
    scaled."""
    x_out, x_ref = (t.double().flatten(1) for t in (x_out, x_ref))
    err = (x_out - x_ref).norm(dim=1)
    ref = x_ref.norm(dim=1)
    numbers = {"state_rel_l2": float(err.norm() / ref.norm()),
               "frame_rel_l2": float((err / ref).max())}
    if x_in is not None:
        step = (x_ref - x_in.double().flatten(1)).norm()
        numbers["step_rel_l2"] = float(err.norm() / step)
    return numbers


def judge(per_step: list, limits: dict) -> tuple[dict, int]:
    """(the worst reading of each number over the compared steps, the count
    of steps with a number above its limit); a number that is not finite
    reads infinite."""
    worst: dict = {}
    failed = 0
    for numbers in per_step:
        bad = False
        for name, v in numbers.items():
            v = v if math.isfinite(v) else math.inf
            worst[name] = max(worst.get(name, -math.inf), v)
            bad |= name in limits and v > limits[name]
        failed += bad
    return worst, failed

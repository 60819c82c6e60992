"""Small host-side helpers: seeding, PSNR, timing, device selection, the
fp32-products scope and the segmentation plan of checkpointed loops."""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch; return a CPU ``torch.Generator`` seeded
    with ``seed`` for the draws the port makes explicitly (pivots)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val**2 / mse)


class Timer:
    """Wall-clock timer: ``with Timer() as t: ...; t.seconds``. Time device
    work only after synchronizing it (:func:`synchronize`)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; anything else, or ``cuda`` without a visible
    GPU, raises (the port never falls back from CUDA to the CPU)."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available")
    return torch.device(name)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in PyTorch's matmuls and cuDNN's convolutions on or off
    inside the block, the flags as they were after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp32_products():
    """TF32 off inside the block (PyTorch's default lets cuDNN take
    10-bit-mantissa products): the fp32 models that run beside a bf16 stack
    (the DPT, the CLIP towers) run full fp32 products, as the JAX package
    runs them."""
    return tf32(False)


def segment_slices(n: int, seg_len: int) -> list[slice]:
    """Contiguous slices of at most ``seg_len`` items covering ``range(n)``
    (``tokenflow_tpu/utils.py::segment_slices``). ``seg_len <= 0`` or
    ``>= n`` means one segment."""
    if seg_len <= 0 or seg_len >= n:
        return [slice(0, n)]
    return [slice(s, min(s + seg_len, n)) for s in range(0, n, seg_len)]


def plan_seg_len(n: int, max_len: int) -> int:
    """The segment length for ``n`` items under a cap of ``max_len``, as
    ``tokenflow_tpu/utils.py::plan_seg_len`` picks it without a mesh: the
    largest divisor of ``n`` up to the cap, unless it more than doubles the
    segment count of the plain cap-plus-tail split. The port keeps the rule
    so that a checkpoint falls on the same step boundaries in both
    packages. Never more than ``max_len``."""
    if max_len <= 0 or max_len >= n:
        return max_len
    naive_count = -(-n // max_len)
    best = next(d for d in range(max_len, 0, -1) if n % d == 0)
    if n // best <= 2 * naive_count:
        return best
    return max_len

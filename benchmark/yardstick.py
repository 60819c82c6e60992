"""The benchmark's arithmetic: the H100's published peaks, the least time a
kernel call could take, the kernel classes of a device trace, and the pieces
every architecture's operation count is made of (``Attn``, ``Match``,
``Pass``, ``_conv``, ``_linear``). Each architecture module counts the
operations of a step from the configuration and the cell's shapes alone
(``architectures/<name>.py::step_ops``), so the same work counts the same
whatever implements it.

``PEAKS``, :func:`bound` and ``KERNEL_CLASSES`` are frozen copies of the
smoke test's (``chip_smoke.py``), kept here so that the yardstick does not
move when the smoke does.
"""

from __future__ import annotations

import dataclasses

# the H100 SXM's published peaks (NVIDIA data sheet), at the 700 W power
# limit: HBM3 bytes/s, dense bf16 and TF32 tensor-core FLOP/s, fp32 FLOP/s
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
PEAKS = {
    "bfloat16": (H100_BF16_FLOPS, "bf16 tensor cores, 989 TFLOP/s"),
    "float32": (H100_TF32_FLOPS / 3, "3xTF32: 3 x flops on the TF32 tensor cores, 495 TFLOP/s"),
}
BYTES = {"bfloat16": 2, "float32": 4}

# torch.profiler kernel classes, first match wins
KERNEL_CLASSES = [
    ("K1 flash attention", ("flash_fwd",)),
    ("K2/K3 token match", ("match_core",)),
    ("fp32 split pre-pass (K1-f32, K2/K3-f32)", ("tf32_split",)),
    ("K4 GroupNorm", ("gn_cluster", "gn_stats", "gn_apply", "gn_resident")),
    ("convolution", ("conv", "cudnn", "xmma_fprop", "implicit", "winograd", "dgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("GroupNorm (PyTorch)", ("group_norm", "groupnorm")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("softmax", ("softmax",)),
    ("copies and casts", ("copy", "memcpy", "cat", "transpose", "permute", "memset", "nhwc")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
]

# the program's attention dispatch when this benchmark was written
# (tokenflow_torch/ops/attention.py): a key length above the UNet's
# kv_block goes to K1, shorter ones to a dense fp32 einsum
KV_BLOCK = 1024
CONTEXT_LEN = 77  # CLIP's token count, the cross-attention keys


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def bound(nbytes: float, flops: float, peak: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``flops`` operations at ``peak`` FLOP/s."""
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


@dataclasses.dataclass(frozen=True)
class Attn:
    """One attention product: B batches of H heads, Sq queries against Skv
    keys of width D; ``role`` "self", "source" (a keyframe's own tokens),
    "extended" (all keyframes' tokens) or "cross"."""

    b: int
    h: int
    sq: int
    skv: int
    d: int
    role: str

    @property
    def flops(self) -> float:
        return 4.0 * self.b * self.h * self.sq * self.skv * self.d

    def least_ms(self, dtype: str = "bfloat16") -> float:
        nbytes = BYTES[dtype] * self.b * self.h * self.d * (2 * self.sq + 2 * self.skv)
        return bound(nbytes, self.flops, PEAKS[dtype][0])[0]

    @property
    def k1(self) -> bool:
        return self.role != "cross" and self.skv > KV_BLOCK


@dataclasses.dataclass(frozen=True)
class Match:
    """One token match + gather: F frames of S tokens of width C against two
    of K pivots, gathering an ns-stream table."""

    f: int
    s: int
    c: int
    k: int
    ns: int

    @property
    def flops(self) -> float:
        return 4.0 * self.f * self.s * self.s * self.c

    def least_ms(self, dtype: str = "bfloat16") -> float:
        tables = (self.f + self.k + self.ns * self.k + self.ns * self.f) * self.s * self.c
        nbytes = BYTES[dtype] * tables + 4 * 2 * self.f * self.s + 12 * self.f
        return bound(nbytes, self.flops, PEAKS[dtype][0])[0]


@dataclasses.dataclass(frozen=True)
class Pass:
    """One UNet call: ``frames`` images in each of ``ns`` streams (batch
    frames x ns), in mode "plain", "pivotal" (keyframes) or "propagate"
    (frames matched against ``pivots`` keyframes)."""

    mode: str
    frames: int
    ns: int = 1
    pivots: int = 0

    @property
    def batch(self) -> int:
        return self.frames * self.ns


def _conv(b, cin, cout, k, res) -> float:
    return 2.0 * b * cout * cin * k * k * res * res


def _linear(tokens, cin, cout) -> float:
    return 2.0 * tokens * cin * cout


def flops(ops: list) -> float:
    return float(sum(o if isinstance(o, float) else o.flops for o in ops))

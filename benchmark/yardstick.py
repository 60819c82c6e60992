"""The benchmark's arithmetic: the H100's published peaks, the least time a
kernel call could take, the kernel classes of a device trace, and the
operations of every UNet and ControlNet pass, worked out from the
configuration and the cell's shapes alone (so the same work counts the same
whatever implements it).

``PEAKS``, :func:`bound` and ``KERNEL_CLASSES`` are frozen copies of the
smoke test's (``chip_smoke.py``), kept here so that the yardstick does not
move when the smoke does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from reference.model import UNetSpec

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


def _resnet(b, cin, cout, temb, res) -> Iterator:
    yield _conv(b, cin, cout, 3, res)
    yield _linear(b, temb, cout)
    yield _conv(b, cout, cout, 3, res)
    if cin != cout:
        yield _conv(b, cin, cout, 1, res)


def _transformer(spec: UNetSpec, level: int, res: int, p: Pass) -> Iterator:
    b, s = p.batch, res * res
    c = spec.block_out_channels[level]
    heads, d = spec.heads[level], spec.head_dim(level)
    inner = heads * d
    yield _linear(b * s, c, inner)  # proj_in (a 1x1 conv counts the same)
    if p.mode == "propagate":
        yield Match(p.frames, s, inner, p.pivots, p.ns)
    else:
        yield 3 * _linear(b * s, inner, inner)
        if p.mode == "pivotal":
            yield Attn(2, heads, p.frames * s, p.frames * s, d, "extended")
            if p.ns == 3:
                yield Attn(p.frames, heads, s, s, d, "source")
        else:
            yield Attn(b, heads, s, s, d, "self")
        yield _linear(b * s, inner, inner)
    yield _linear(b * s, inner, inner)  # attn2.to_q
    yield 2 * _linear(b * CONTEXT_LEN, spec.cross_attention_dim, inner)
    yield Attn(b, heads, s, CONTEXT_LEN, d, "cross")
    yield _linear(b * s, inner, inner)
    yield _linear(b * s, inner, 8 * inner)
    yield _linear(b * s, 4 * inner, inner)
    yield _linear(b * s, inner, c)  # proj_out


def _encoder(spec: UNetSpec, p: Pass, hw: int, skips: list) -> Iterator:
    ch, b = spec.block_out_channels, p.batch
    temb = 4 * ch[0]
    yield _linear(b, ch[0], temb)
    yield _linear(b, temb, temb)
    yield _conv(b, spec.in_channels, ch[0], 3, hw)
    skips.append((ch[0], hw))
    cin, res = ch[0], hw
    for i, c in enumerate(ch):
        for _ in range(spec.layers_per_block):
            yield from _resnet(b, cin, c, temb, res)
            cin = c
            if spec.attn_down[i]:
                yield from _transformer(spec, i, res, p)
            skips.append((c, res))
        if i < len(ch) - 1:
            res //= 2
            yield _conv(b, c, c, 3, res)
            skips.append((c, res))
    yield from _resnet(b, ch[-1], ch[-1], temb, res)
    yield from _transformer(spec, len(ch) - 1, res, p)
    yield from _resnet(b, ch[-1], ch[-1], temb, res)


def unet_ops(spec: UNetSpec, p: Pass, hw: int) -> list:
    """The operations of one UNet call at latent size ``hw``: numbers (the
    FLOPs of a convolution or linear layer), ``Attn`` and ``Match``."""
    skips: list = []
    ops = list(_encoder(spec, p, hw, skips))
    ch, b = spec.block_out_channels, p.batch
    temb = 4 * ch[0]
    rev = ch[::-1]
    cin, res = ch[-1], hw // 2 ** (len(ch) - 1)
    for i in range(len(ch)):
        for _ in range(spec.layers_per_block + 1):
            ops += _resnet(b, cin + skips.pop()[0], rev[i], temb, res)
            cin = rev[i]
            if spec.attn_up[i]:
                ops += _transformer(spec, len(ch) - 1 - i, res, p)
        if i < len(ch) - 1:
            res *= 2
            ops.append(_conv(b, rev[i], rev[i], 3, res))
    ops.append(_conv(b, ch[0], spec.out_channels, 3, hw))
    return ops


def controlnet_ops(spec: UNetSpec, p: Pass, hw: int) -> list:
    """The operations of one ControlNet call at latent size ``hw``, its
    conditioning image 2^(len(cond_channels) - 1) times larger."""
    b, cc = p.batch, spec.cond_channels
    res = hw * 2 ** (len(cc) - 1)
    ops = [_conv(b, 3, cc[0], 3, res)]
    for i in range(len(cc) - 1):
        ops.append(_conv(b, cc[i], cc[i], 3, res))
        res //= 2
        ops.append(_conv(b, cc[i], cc[i + 1], 3, res))
    ops.append(_conv(b, cc[-1], spec.block_out_channels[0], 3, hw))
    plain = Pass("plain", p.frames, p.ns)
    skips: list = []
    ops += _encoder(spec, plain, hw, skips)
    ops += [_conv(b, c, c, 1, r) for c, r in skips]
    c = spec.block_out_channels[-1]
    ops.append(_conv(b, c, c, 1, hw // 2 ** (len(spec.block_out_channels) - 1)))
    return ops


def flops(ops: list) -> float:
    return float(sum(o if isinstance(o, float) else o.flops for o in ops))


def step_ops(stage: str, unet: UNetSpec, controlnet, traffic: dict) -> list:
    """Every operation of one step of ``stage`` ("edit": the pivotal pass
    over the keyframes and the propagation pass over all frames, three
    streams each; "invert": one plain call over all frames), ControlNet
    calls included where the configuration has one."""
    hw = traffic["resolution"] // 8
    f = traffic["frames"]
    if stage == "edit":
        k = f // traffic["window"]
        passes = [Pass("pivotal", k, 3), Pass("propagate", f, 3, k)]
    elif stage == "invert":
        passes = [Pass("plain", f, 1)]
    else:
        raise ValueError(f"no operation count for stage {stage!r}")
    ops = []
    for p in passes:
        ops += unet_ops(unet, p, hw)
        if controlnet is not None:
            ops += controlnet_ops(controlnet, p, hw)
    return ops

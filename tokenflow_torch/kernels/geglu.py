"""K7: the GEGLU feed-forward's projection and activation, the hand-written
CUDA kernel and its plain version.

``ff.net.0.proj`` and the GEGLU of every transformer block
(``models/layers.py::GEGLU``): for x (..., K), the projection's weight W
(2N, K) ([hidden | gate] rows, as ``nn.Linear`` holds it) and bias b (2N,),

    out = (x W[:N]^T + b[:N]) * gelu_erf(x W[N:]^T + b[N:])

as (..., N). The plain version (:func:`geglu_plain`) computes it as the
port always did: ``F.linear`` into an (..., 2N) tensor, ``chunk``,
``F.gelu`` and the product, each rounded to x's dtype. The kernel keeps the
projection on chip: fp32 sums, both biases, the exact GELU and the product
in fp32, one rounding to bf16. The CUDA source is
``tokenflow_torch/csrc/geglu_gemm.cu``; its header gives the design
(persistent blocks, a TMA ring, two consumer warpgroups sharing 128-row
tiles, the epilogue in registers and a TMA store).

:func:`plan` picks the tile's output columns from the shape alone: 128
unless that leaves fewer than ``MIN_WAVES`` waves of tiles over the H100's
132 SMs, then 64. The kernel is instantiated for bf16 x, weight and bias,
K in ``WIDTHS`` and N in ``INNERS`` (the UNets' transformer widths and
four times them); anything else on CUDA raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenflow_torch.kernels import _build

# kernel launches made by :func:`geglu_kernel` (reset by callers)
launches = 0
# launches by plan ("cols128", "cols64"), the same launches as ``launches``
launches_by_plan: dict[str, int] = {}

WIDTHS = (320, 640, 1280)  # K: the transformer widths of SD-1.5, SD-2.1, SD-XL
INNERS = (1280, 2560, 5120)  # N: four times a width
TILE_ROWS = 128  # x rows of a tile (csrc/geglu_gemm.cu, kBM)
PLAN_COLS = {"cols128": 128, "cols64": 64}  # output columns of a tile, by plan
SMS = 132  # the H100's SMs: one persistent block each
MIN_WAVES = 4  # the fewest waves of 128-column tiles that keep that plan


def plan(m: int, k: int, n: int) -> str:
    """The plan K7 takes for x (m, k) and N = n output columns: tiles of 128
    output columns unless they make fewer than ``MIN_WAVES`` waves over the
    SMs (the pivotal pass's 960 rows at 8^2 make 2.4), then tiles of 64.
    Raises for a width the kernel is not admitted at."""
    if k not in WIDTHS or n not in INNERS:
        raise NotImplementedError(
            f"the CUDA GEGLU kernel takes K in {WIDTHS} and N in {INNERS}; got K {k}, N {n}"
        )
    if m <= 0:
        raise ValueError(f"no rows to plan for: m = {m}")
    tiles = -(-m // TILE_ROWS) * (n // PLAN_COLS["cols128"])
    return "cols128" if tiles >= MIN_WAVES * SMS else "cols64"


def geglu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The GEGLU in plain PyTorch, in x's dtype: the projection, split
    [hidden | gate], hidden * the exact (erf) GELU of the gate."""
    h, gate = F.linear(x, weight, bias).chunk(2, dim=-1)
    return h * F.gelu(gate)


def geglu_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors x (..., K), weight (2N, K), bias (2N,), all
    bf16, contiguous, 16-byte aligned, on one device; returns a new (..., N)
    bf16 tensor."""
    global launches
    k = x.shape[-1] if x.dim() else 0
    if weight.dim() != 2 or weight.shape[1] != k or weight.shape[0] % 2 or bias.shape != (
            weight.shape[0],):
        raise ValueError(
            f"expected x (..., K), weight (2N, K), bias (2N,); got {tuple(x.shape)}, "
            f"{tuple(weight.shape)}, {tuple(bias.shape)}"
        )
    n = weight.shape[0] // 2
    if not (x.dtype == weight.dtype == bias.dtype == torch.bfloat16):
        raise NotImplementedError(
            "the CUDA GEGLU kernel is instantiated for bf16 x, weight and bias; got "
            f"{x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    m = x.numel() // k
    p = plan(max(m, 1), k, n)  # raises for a width the kernel is not admitted at
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu_kernel needs {name} contiguous and 16-byte aligned")
    device = x.device
    if device.type != "cuda" or weight.device != device or bias.device != device:
        raise ValueError(
            "geglu_kernel needs x, weight and bias on one CUDA device, got "
            f"{x.device}, {weight.device}, {bias.device}"
        )
    out = x.new_empty((*x.shape[:-1], n))
    if m == 0:
        return out
    lib = _build.load_library()
    args = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), m, k, n,
            PLAN_COLS[p], torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        rc = lib.tf_geglu_gemm(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.tf_geglu_gemm(*args)
    _build.check(lib, rc, "geglu_kernel launch")
    launches += 1
    launches_by_plan[p] = launches_by_plan.get(p, 0) + 1
    return out

"""K7's module (``tokenflow_torch/kernels/geglu.py``): the plan as a pure
function of (M, K, N) at every shape the configurations give it, the
wrapper's refusals, the dispatch rule of ``models/layers.py::GEGLU``, the
CPU path left as it was, the GEGLU calls a model call makes (K7's launches
per call on the card), the kernel's tile order and arithmetic emulated,
guards on the CUDA source, and (on a card only) the kernel against the
plain version in fp32. The port's GEGLU against the JAX
``GEGLUFeedForward`` is held in ``tests/test_torch_goldens.py`` (this file
imports no JAX, so that its card test runs where JAX is absent).

Limit: at most ``MAX_ULPS`` = 1 bf16 step, counted at max(|ref|, 2^-6) as
the norm kernels' tests count it, against the plain version in fp32 on
fp32 copies of the same bf16 inputs: K7 rounds once (half a step) after
fp32 sums in another order (about 1e-6 relative).
"""

import importlib.util
import math
import re
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels import geglu as tgg
from tokenflow_torch.models import layers
from tokenflow_torch.models.controlnet import ControlNetModel
from tokenflow_torch.models.layers import GEGLU, GEGLUFeedForward
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tokenflow_torch" / "csrc" / "geglu_gemm.cu"
MAX_ULPS = 1.0
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def _inputs(m, k, n, seed, dtype=BF16, device="cpu"):
    """x (m, k) around the unit scale of a LayerNorm's output, the
    projection's weight (2n, k) and bias (2n,) at nn.Linear's scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((2 * n, k), generator=g) * k**-0.5
    b = 0.1 * torch.randn((2 * n,), generator=g)
    return tuple(t.to(device=device, dtype=dtype) for t in (x, w, b))


def _bf16_steps(got, want, floor=2.0**-6):
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(floor))) - 7)
    return float(((got - want).abs() / ulp).max())


# ------------------------------------------------------------- the plan


def _path_shapes() -> set:
    """(M, K, N) of every GEGLU the configurations run: SD-1.5 / SD-2.1 (and
    the ControlNet's encoder) at 512^2 and 768^2, SD-XL at 1024^2, over the
    image counts of the pivotal pass (keyframes x streams), the propagation
    pass, the fused step, the inversion, a frames group's rank and the
    smoke's 24-frame SDEdit."""
    shapes = set()
    images = (1, 2, 3, 8, 10, 15, 20, 24, 30, 40, 48, 60, 72, 80, 120, 135)
    sd = {512: [(64, 320), (32, 640), (16, 1280), (8, 1280)],
          768: [(96, 320), (48, 640), (24, 1280), (12, 1280)],
          1024: [(64, 640), (32, 1280)]}  # SD-XL: no attention at 128^2
    for levels in sd.values():
        for side, k in levels:
            for b in images:
                shapes.add((b * side * side, k, 4 * k))
    return shapes


@pytest.mark.parametrize("m,k,n,want", [
    (491520, 320, 1280, "cols128"),  # PnP propagation, 64^2
    (122880, 640, 2560, "cols128"),  # 32^2
    (30720, 1280, 5120, "cols128"),  # 16^2
    (7680, 1280, 5120, "cols128"),  # the 8^2 mid block over 120 images
    (2560, 1280, 5120, "cols128"),  # the inversion's 8^2 mid block: 6 waves
    (3840, 1280, 5120, "cols128"),  # the pivotal pass at 16^2
    (960, 1280, 5120, "cols64"),  # the pivotal pass's 8^2 mid block: 2.4 waves
    (640, 1280, 5120, "cols64"),  # SDEdit's two-stream pivotal pass at 8^2
    (491520, 640, 2560, "cols128"),  # SD-XL 64^2
    (122880, 1280, 5120, "cols128"),  # SD-XL 32^2
    (1, 320, 1280, "cols64"),
])
def test_plan_at_the_paths_rows(m, k, n, want):
    assert tgg.plan(m, k, n) == want


def test_plan_is_a_pure_function_of_the_shape():
    """At every shape the configurations give: a plan, the same on every
    call, 128-column tiles exactly where they make at least MIN_WAVES
    waves over the card's SMs."""
    shapes = _path_shapes()
    assert len(shapes) > 100
    for m, k, n in sorted(shapes):
        p = tgg.plan(m, k, n)
        assert p == tgg.plan(m, k, n) and p in tgg.PLAN_COLS
        waves = math.ceil(m / tgg.TILE_ROWS) * (n // 128) / tgg.SMS
        assert (p == "cols128") == (waves >= tgg.MIN_WAVES), (m, k, n)


@pytest.mark.parametrize("k,n", [(256, 1280), (320, 1024), (768, 3072), (1024, 4096),
                                 (320, 640), (2048, 8192)])
def test_plan_refuses_widths_the_kernel_lacks(k, n):
    with pytest.raises(NotImplementedError, match="K in"):
        tgg.plan(4096, k, n)


def test_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="no rows"):
        tgg.plan(0, 320, 1280)


# ------------------------------------------------------- the wrapper


@pytest.mark.parametrize("case,error,match", [
    ("x_f32", NotImplementedError, "bf16"),
    ("w_f16", NotImplementedError, "bf16"),
    ("bias_f32", NotImplementedError, "bf16"),
    ("k_300", ValueError, "expected x"),
    ("n_odd_rows", ValueError, "expected x"),
    ("bias_shape", ValueError, "expected x"),
    ("width_256", NotImplementedError, "K in"),
    ("inner_1024", NotImplementedError, "K in"),
    ("x_strided", ValueError, "contiguous"),
    ("w_transposed_view", ValueError, "contiguous"),
    ("x_misaligned", ValueError, "16-byte"),
    ("cpu", ValueError, "CUDA device"),
])
def test_wrapper_refuses(case, error, match):
    """Dtypes, shapes, widths and layouts are checked before the device, so
    every refusal shows here on the CPU; valid CPU tensors are refused for
    the device last."""
    x, w, b = _inputs(8, 320, 1280, seed=1)
    if case == "x_f32":
        x = x.float()
    elif case == "w_f16":
        w = w.half()
    elif case == "bias_f32":
        b = b.float()
    elif case == "k_300":
        x = x[:, :300].contiguous()
    elif case == "n_odd_rows":
        w, b = w[:-1], b[:-1]
    elif case == "bias_shape":
        b = b[:-2]
    elif case == "width_256":
        x, w = x[:, :256].contiguous(), w[:, :256].contiguous()
    elif case == "inner_1024":
        w, b = w[:2048], b[:2048]
    elif case == "x_strided":
        x = torch.empty((8, 640), dtype=BF16)[:, ::2]
    elif case == "w_transposed_view":
        w = torch.empty((320, 2560), dtype=BF16).t()
    elif case == "x_misaligned":
        x = torch.empty(8 * 320 + 1, dtype=BF16)[1:].view(8, 320)
    with pytest.raises(error, match=match):
        tgg.geglu_kernel(x, w, b)


# ------------------------------------------------------- the dispatch


class _Fake:
    """What the dispatch reads of a tensor: its device and dtype."""

    def __init__(self, dtype, cuda):
        self.dtype, self.is_cuda = dtype, cuda


@pytest.mark.parametrize("dtype,cuda,want,counted", [
    (BF16, True, "k7", 0),
    (F32, True, "plain", 1),
    (F16, True, "plain", 1),
    (BF16, False, "plain", 0),
    (F32, False, "plain", 0),
])
def test_dispatch_rule(monkeypatch, dtype, cuda, want, counted):
    """A bf16 CUDA input launches K7 with the projection's own weight and
    bias; every other input takes the plain version, the CUDA ones counted
    in ``GEGLU.plain_on_cuda``."""
    taken = []

    def stub(name):
        def call(x, weight, bias):
            taken.append((name, weight, bias))
            return name
        return call

    monkeypatch.setattr(layers, "geglu_kernel", stub("k7"))
    monkeypatch.setattr(layers, "geglu_plain", stub("plain"))
    monkeypatch.setattr(GEGLU, "plain_on_cuda", 0)
    mod = GEGLU(320, 1280)
    assert mod(_Fake(dtype, cuda)) == want
    assert [t[0] for t in taken] == [want]
    assert taken[0][1] is mod.proj.weight and taken[0][2] is mod.proj.bias
    assert GEGLU.plain_on_cuda == counted


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_path_unchanged_and_never_loads_the_library(monkeypatch, dtype):
    """On the CPU the GEGLU is the projection, the split and hidden * the
    exact GELU, bit for bit as before K7; the kernel library is never
    loaded and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was loaded on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    torch.manual_seed(0)
    mod = GEGLU(320, 1280).to(dtype)
    x = torch.randn(2, 37, 320).to(dtype)
    launches = tgg.launches
    h, gate = mod.proj(x).chunk(2, dim=-1)
    assert torch.equal(mod(x), h * F.gelu(gate))
    assert torch.equal(mod(x), tgg.geglu_plain(x, mod.proj.weight, mod.proj.bias))
    ff = GEGLUFeedForward(320).to(dtype)
    assert ff(x).shape == x.shape
    assert tgg.launches == launches


def _geglu_calls(model, run) -> int:
    """GEGLU calls of one model call on the meta device (no weights made;
    attention stubbed, its output shape is all that counts)."""
    calls = [0]

    def count(module, args):
        calls[0] += 1

    for m in model.modules():
        if isinstance(m, GEGLU):
            m.register_forward_pre_hook(count)
    stub = lambda q, k, v, **kw: torch.empty_like(q)  # noqa: E731
    with torch.no_grad(), mock.patch.object(layers, "flash_attention", stub):
        run(model)
    return calls[0]


@pytest.mark.parametrize("model,want", [
    ("sd21", 16), ("sd15", 16), ("sd15_controlnet", 7), ("sdxl", 70),
])
def test_geglu_calls_per_model_call(model, want):
    """One GEGLU per transformer block a call runs, so K7's launches per
    call on the card: 16 a SD UNet call, 7 a ControlNet call, 70 a SD-XL
    UNet call (a PnP step 32, ControlNet 46, the inversion 16, SD-XL's
    two-pass edit 140)."""
    cfg = {"sd21": UNet2DConfig.sd21_base, "sd15": UNet2DConfig.sd15,
           "sd15_controlnet": UNet2DConfig.sd15, "sdxl": UNet2DConfig.sdxl_base}[model]()
    meta = dict(device="meta")
    ctx = torch.empty(1, 77, cfg.cross_attention_dim, **meta)
    lat = torch.empty(1, 8, 8, 4, **meta)
    with torch.device("meta"):
        net = ControlNetModel(cfg) if model.endswith("controlnet") else UNet2DConditionModel(cfg)
    if model.endswith("controlnet"):
        run = lambda m: m(lat, 1, ctx, torch.empty(1, 64, 64, 3, **meta))  # noqa: E731
    elif model == "sdxl":
        added = {"text_embeds": torch.empty(1, 1280, **meta),
                 "time_ids": torch.empty(1, 6, **meta)}
        run = lambda m: m(lat, 1, ctx, added_cond=added)  # noqa: E731
    else:
        run = lambda m: m(lat, 1, ctx)  # noqa: E731
    assert _geglu_calls(net, run) == want


# ------------------------------------------------------- the CUDA source


def _kernel_names(src: str) -> list[str]:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)


def test_kernel_is_filed_as_a_matmul(monkeypatch):
    """The yardstick files a kernel whose name holds ``gemm`` as a matmul,
    and no name of K7's holds K1's ``flash_fwd`` or the match core's
    ``match_core``."""
    names = _kernel_names(SOURCE.read_text())
    assert names == ["geglu_gemm"]
    spec = importlib.util.spec_from_file_location(
        "k7_test_yardstick", ROOT / "benchmark" / "yardstick.py")
    yardstick = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, yardstick)
    spec.loader.exec_module(yardstick)
    for name in names:
        assert "flash_fwd" not in name and "match_core" not in name
        assert yardstick.kernel_class(f"void (anonymous namespace)::{name}<128>(...)") == "matmul"


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()
    launcher = re.search(r'extern "C" int tf_geglu_gemm\((.*?)\n\}', src, re.S).group(1)
    cols = {int(c): int(n) for c, n in re.findall(r"case (\d+): return launch<(\d+)>", launcher)}
    assert cols == {c: c for c in tgg.PLAN_COLS.values()}
    assert int(re.search(r"kBM = (\d+);", src).group(1)) == tgg.TILE_ROWS
    assert int(re.search(r"kGroupRows = (\d+);", src).group(1)) == GROUP_ROWS
    assert "tf_geglu_gemm" in _build.SIGNATURES
    assert all(k % 64 == 0 for k in tgg.WIDTHS)
    assert all(n % c == 0 for n in tgg.INNERS for c in tgg.PLAN_COLS.values())


# ------------------------------------------------- the kernel, emulated

GROUP_ROWS = 2048  # x rows of a tile group (csrc/geglu_gemm.cu, kGroupRows)


def _tile(t: int, m: int, n: int, cols: int) -> tuple[int, int]:
    """Tile t's first row and first output column, in the kernel's order:
    groups of GROUP_ROWS rows, each walked column block by column block."""
    rows = tgg.TILE_ROWS
    mblocks, nblocks, group = -(-m // rows), n // cols, GROUP_ROWS // rows
    grp, within = divmod(t, group * nblocks)
    in_group = min(group, mblocks - grp * group)
    return (grp * group + within % in_group) * rows, (within // in_group) * cols


@pytest.mark.parametrize("m,n,cols", [(1000, 1280, 128), (960, 5120, 64), (4096, 2560, 128),
                                      (2048 * 3 + 130, 1280, 128), (63, 1280, 64)])
def test_tile_order_covers_every_tile_once(m, n, cols):
    """Every (row block, column block) is one tile, and consecutive tiles of
    a group share a column block, so a group's W tile serves its rows."""
    rows = tgg.TILE_ROWS
    mblocks, nblocks = -(-m // rows), n // cols
    tiles = [_tile(t, m, n, cols) for t in range(mblocks * nblocks)]
    assert sorted(tiles) == sorted((mb * rows, nb * cols)
                                   for mb in range(mblocks) for nb in range(nblocks))
    group = min(GROUP_ROWS // rows, mblocks)
    assert {n0 for _, n0 in tiles[:group]} == {0}


def _emulate(x, w, b, fault=None):
    """K7's arithmetic in plain PyTorch on bf16 inputs: fp32 products and
    sums, both biases and the GELU in fp32, one rounding. ``fault``:
    "tanh_gelu" takes the tanh approximation, "gate_swapped" multiplies the
    gate by the GELU of the hidden half."""
    n = w.shape[0] // 2
    y = F.linear(x.float(), w.float(), b.float())
    h, g = y[:, :n], y[:, n:]
    if fault == "gate_swapped":
        h, g = g, h
    act = F.gelu(g, approximate="tanh" if fault == "tanh_gelu" else "none")
    return (h * act).to(BF16)


@pytest.mark.parametrize("k", tgg.WIDTHS)
def test_emulated_kernel_meets_the_limit(k):
    x, w, b = _inputs(300, k, 4 * k, seed=k)
    want = tgg.geglu_plain(x.float(), w.float(), b.float())
    assert _bf16_steps(_emulate(x, w, b), want) <= MAX_ULPS


@pytest.mark.parametrize("fault", ["tanh_gelu", "gate_swapped"])
def test_emulated_faults_break_the_limit(fault):
    x, w, b = _inputs(300, 320, 1280, seed=3)
    want = tgg.geglu_plain(x.float(), w.float(), b.float())
    assert _bf16_steps(_emulate(x, w, b, fault), want) > MAX_ULPS


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K7 against the plain version in fp32 at every (K, N) pair, both plans,
    ragged M; two launches bitwise equal; the counters (skips without a
    GPU; chip_smoke.py's [K7] rows cover the paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    for k in tgg.WIDTHS:
        for m in (1, 333, 960, 9000):
            x, w, b = _inputs(m, k, 4 * k, seed=m + k, device="cuda")
            before = dict(tgg.launches_by_plan)
            got = tgg.geglu_kernel(x.view(1, m, k), w, b)
            p = tgg.plan(m, k, 4 * k)
            assert tgg.launches_by_plan[p] == before.get(p, 0) + 1
            assert got.shape == (1, m, 4 * k)
            assert torch.equal(got, tgg.geglu_kernel(x.view(1, m, k), w, b))
            want = tgg.geglu_plain(x.float(), w.float(), b.float())
            assert _bf16_steps(got[0].cpu(), want.cpu()) <= MAX_ULPS, (m, k)
    with pytest.raises(NotImplementedError, match="bf16"):
        tgg.geglu_kernel(x.float(), w, b)

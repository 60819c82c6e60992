"""K5's module (``tokenflow_torch/kernels/layer_norm.py``): the plain version
against fp32 ``F.layer_norm`` and against today's CPU ``LayerNorm32``, the
plan, the kernel's lane order emulated, the dispatch rule, and the norm
sites a model call runs (what the launch counters must read per call on
the card).

Tolerances: fp32 within ``_f32_limit`` of an fp64 LayerNorm, 2e-6 on
centred rows and 1.02e-4 where the mean is 100x the spread (the fp32 input
and mean round at ~8e-6 there; the two-pass statistics read 2e-5 to 5e-5,
and ``E[x^2] - E[x]^2`` in fp32, cancelling, 7.5e-3 to 1.1e-2); bf16 at
most 1 bf16 step, counted at max(|ref|, 2^-6), as the GroupNorm tests
count it.
"""

import re
from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from tokenflow_torch.kernels import layer_norm as tln
from tokenflow_torch.models import layers
from tokenflow_torch.models.controlnet import ControlNetModel
from tokenflow_torch.models.layers import FusedGroupNorm, LayerNorm32
from tokenflow_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig

torch.set_num_threads(2)

WIDTHS = (320, 640, 768, 1024, 1280)  # the UNets' and ControlNet's rows, CLIP L and H


def _rows(c, n, seed, offset=0.0):
    """n rows of width c, each with a mean of its own plus ``offset``
    (rows whose mean is 100x their unit spread at offset 100), and weights
    around 1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c), generator=g) + offset + torch.randn((n, 1), generator=g)
    w = 1 + 0.5 * torch.randn((c,), generator=g)
    b = 0.5 * torch.randn((c,), generator=g)
    return x, w, b


def _bf16_steps(got, want, floor=2.0**-6):
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(floor))) - 7)
    return float(((got - want).abs() / ulp).max())


def _f32_limit(offset):
    return 1e-6 * (2 + offset)


def _f64_layer_norm(x, w, b, eps):
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    var = ((xd - mean) ** 2).mean(-1, keepdim=True)
    return (xd - mean) / torch.sqrt(var + eps) * w.double() + b.double()


@pytest.mark.parametrize("offset", [0.0, 100.0], ids=["centred", "mean_100x_spread"])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_matches_f32_layer_norm(c, offset):
    """fp32: layer_norm_plain and F.layer_norm within the fp32 limit of
    fp64, also on rows whose mean is 100x their spread."""
    x, w, b = _rows(c, 64, seed=c, offset=offset)
    want = _f64_layer_norm(x, w, b, 1e-5)
    got = tln.layer_norm_plain(x, w, b, 1e-5)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < _f32_limit(offset)
    lib = F.layer_norm(x, (c,), w, b, 1e-5)
    assert float((lib.double() - want).abs().max()) < _f32_limit(offset)


def test_one_pass_variance_fails_the_f32_limit():
    """The control: ``E[x^2] - E[x]^2`` in fp32 on the same rows, mean 100x
    the spread, misses the limit the two-pass statistics meet."""
    x, w, b = _rows(320, 64, seed=320, offset=100.0)
    mean = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mean * mean
    naive = (x - mean) * torch.rsqrt(var + 1e-5) * w + b
    err = float((naive.double() - _f64_layer_norm(x, w, b, 1e-5)).abs().max())
    assert err > 10 * _f32_limit(100.0)


@pytest.mark.parametrize("offset", [0.0, 100.0], ids=["centred", "mean_100x_spread"])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_bf16_within_one_step_of_layer_norm32(c, offset):
    """bf16: layer_norm_plain within 1 bf16 step of today's LayerNorm32 (the
    CPU path, F.layer_norm on an fp32 copy) on bf16 inputs and weights."""
    x, w, b = _rows(c, 96, seed=c + 1, offset=offset)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    m = LayerNorm32(c, eps=1e-5).bfloat16()
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        today = m(x)
    got = tln.layer_norm_plain(x, w, b, 1e-5)
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got, today) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm32_cpu_path_unchanged(dtype):
    """On the CPU LayerNorm32 is F.layer_norm on an fp32 copy, cast back,
    bit for bit."""
    x, w, b = _rows(640, 16, seed=5)
    m = LayerNorm32(640, eps=1e-5).to(dtype)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        x = x.to(dtype)
        want = F.layer_norm(x.float(), (640,), m.weight.float(), m.bias.float(), 1e-5)
        assert torch.equal(m(x), want.to(dtype))


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.bfloat16, "kernel"), ("cuda:0", torch.bfloat16, "kernel"),
    ("cuda", torch.float32, "torch"), ("cpu", torch.bfloat16, "torch"),
    ("cpu", torch.float32, "torch"), ("meta", torch.bfloat16, "torch"),
])
def test_layer_norm_path_rule(device, dtype, want):
    """K5 for bf16 on CUDA; an fp32 stack and every other device keep
    F.layer_norm."""
    assert layers.layer_norm_path(device, dtype) == want


def test_layer_norm32_dispatches_by_path(monkeypatch):
    """``LayerNorm32.forward`` calls K5 where the rule says "kernel", with
    the module's weight, bias and eps (the device stubbed: no card here)."""
    calls = []

    def kernel(x, w, b, eps):
        calls.append((tuple(x.shape), eps))
        return x

    monkeypatch.setattr(layers, "layer_norm_kernel", kernel)
    monkeypatch.setattr(layers, "layer_norm_path", lambda device, dtype: "kernel")
    m = LayerNorm32(320, eps=1e-6)
    x = torch.randn(2, 7, 320)
    assert m(x) is x
    assert calls == [((2, 7, 320), 1e-6)]


@pytest.mark.parametrize("c", WIDTHS + (8, 64, 200, 1536, 2048))
def test_plan_covers_each_row(c):
    """Every lane of a row's segment holds at least one vector, the
    segment's vectors cover the row, and the model widths take at most five
    vectors a lane."""
    p = tln.plan(c)
    n_vec = c // 8
    assert p.lanes in tln.LANES and 1 <= p.vecs <= tln.MAX_VECS
    assert p.lanes * p.vecs >= n_vec > p.lanes * (p.vecs - 1)
    if c in WIDTHS:
        assert p.vecs <= 5
    assert {320: (8, 5), 640: (16, 5), 1280: (32, 5), 768: (32, 3),
            1024: (32, 4)}.get(c, tuple(p)) == tuple(p)


@pytest.mark.parametrize("c", [0, 100, 321, 2824, 4096])
def test_plan_refuses_widths_the_kernel_lacks(c):
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        tln.plan(c)


def test_plan_constants_match_the_cuda_source():
    src = (Path(tln.__file__).resolve().parents[1] / "csrc" / "layer_norm.cu").read_text()
    assert int(re.search(r"constexpr int kMaxVecs = (\d+);", src).group(1)) == tln.MAX_VECS
    lanes = re.search(r"Kernel kernel_for\(int lanes, int vecs\) \{(.*?)\n\}", src, re.S).group(1)
    assert tuple(int(n) for n in re.findall(r"case (\d+):", lanes)) == tln.LANES


def _emulate(x, w, b, eps, p, fault=None):
    """K5 in plain PyTorch in the kernel's order: lane l of a row's segment
    sums its vectors l, l + lanes, ... (8 elements each, in order), the
    segment reduces by xor shuffles (offsets lanes/2 .. 1), mean = sum / C,
    then the squared deviations the same way, y = fma((x - mean) * rstd,
    gamma, beta). ``fault``: "skip_last_vec" (each lane's last vector
    left out of the sums), "no_centre" (the second pass sums x^2)."""
    rows, c = x.shape
    xf = x.float()
    n_vec = c // 8
    vecs = p.vecs - (1 if fault == "skip_last_vec" else 0)

    def lane_sums(values):
        out = torch.zeros(rows, p.lanes)
        for lane in range(p.lanes):
            for j in range(vecs):
                v = lane + j * p.lanes
                if v < n_vec:
                    for k in range(8):
                        out[:, lane] = out[:, lane] + values[:, 8 * v + k]
        off = p.lanes // 2
        while off:
            out = out + out[:, torch.arange(p.lanes) ^ off]
            off //= 2
        return out[:, 0]

    mean = lane_sums(xf) / c
    d = xf if fault == "no_centre" else xf - mean[:, None]
    var = lane_sums(d * d) / c
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean[:, None]) * rstd[:, None] * w.float() + b.float()
    return y.to(x.dtype)


@pytest.mark.parametrize("fault", [None, "skip_last_vec", "no_centre"])
@pytest.mark.parametrize("c", [320, 768])
def test_emulated_kernel_order_matches_plain(c, fault):
    """The kernel's lane order gives layer_norm_plain within 1 bf16 step;
    each planted fault breaks that."""
    x, w, b = _rows(c, 8, seed=9, offset=3.0)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    got = _emulate(x, w, b, 1e-5, tln.plan(c), fault)
    steps = _bf16_steps(got, tln.layer_norm_plain(x, w, b, 1e-5))
    assert (steps <= 1.0) == (fault is None), steps


def test_kernel_wrapper_rejects_cpu_tensors():
    x, w = torch.randn(4, 320).bfloat16(), torch.ones(320).bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_kernel(x, w, w, 1e-5)


def _norm_calls(model, run) -> dict:
    """GroupNorm and LayerNorm calls of one model call on the meta device
    (no weights made; attention stubbed, its output shape is all that
    counts)."""
    counts = {"group_norm": 0, "layer_norm": 0}

    def hook(name):
        def count(module, args):
            counts[name] += 1
        return count

    for m in model.modules():
        if isinstance(m, FusedGroupNorm):
            m.register_forward_pre_hook(hook("group_norm"))
        elif isinstance(m, LayerNorm32):
            m.register_forward_pre_hook(hook("layer_norm"))
    stub = lambda q, k, v, **kw: torch.empty_like(q)  # noqa: E731
    with torch.no_grad(), mock.patch.object(layers, "flash_attention", stub):
        run(model)
    return counts


@pytest.mark.parametrize("model,want", [
    ("sd21", {"group_norm": 61, "layer_norm": 48}),
    ("sd15", {"group_norm": 61, "layer_norm": 48}),
    ("sd15_controlnet", {"group_norm": 27, "layer_norm": 21}),
])
def test_norm_sites_per_model_call(model, want):
    """The norm sites one call runs, so K4's and K5's launches per call on
    the card: 61 GroupNorms and 48 LayerNorms a UNet call (SD-2.1 and
    SD-1.5), 27 and 21 a ControlNet call."""
    cfg = UNet2DConfig.sd15() if model.startswith("sd15") else UNet2DConfig.sd21_base()
    ctx = torch.empty(1, 77, cfg.cross_attention_dim, device="meta")
    lat = torch.empty(1, 8, 8, 4, device="meta")
    with torch.device("meta"):
        net = ControlNetModel(cfg) if model.endswith("controlnet") else UNet2DConditionModel(cfg)
    if model.endswith("controlnet"):
        run = lambda m: m(lat, 1, ctx, torch.empty(1, 64, 64, 3, device="meta"))  # noqa: E731
    else:
        run = lambda m: m(lat, 1, ctx)  # noqa: E731
    assert _norm_calls(net, run) == want


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K5 against its plain version on the card at the model widths, rows
    far from zero included; two launches bitwise equal; the counters
    (skips without a GPU; chip_smoke.py covers the paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    for c in WIDTHS:
        x, w, b = (t.cuda().bfloat16() for t in _rows(c, 1000, seed=c, offset=100.0))
        before = tln.launches
        got = tln.layer_norm_kernel(x, w, b, 1e-5)
        assert tln.launches == before + 1
        assert tln.launches_by_shape[(1000, c)] >= 1
        assert torch.equal(got, tln.layer_norm_kernel(x, w, b, 1e-5))
        assert _bf16_steps(got.cpu(), tln.layer_norm_plain(x, w, b, 1e-5).cpu()) <= 1.0
    with pytest.raises(NotImplementedError, match="bf16"):
        tln.layer_norm_kernel(x.float(), w, b, 1e-5)


# ---------------------------------------------------------------------------
# the rotary entry: HunyuanDiT's per-head q/k norm and 2-D RoPE in one launch


def _rope_inputs(b, s_grid, heads, d, seed, dtype=torch.bfloat16):
    """x (b, S, heads, d) with S = s_grid^2 tokens, per-head weights, and
    the model's RoPE tables for an s_grid x s_grid token grid."""
    from tokenflow_torch.models.hunyuan_dit import rope_tables

    g = torch.Generator().manual_seed(seed)
    s = s_grid * s_grid
    x = torch.randn((b, s, heads, d), generator=g) + torch.randn((b, s, heads, 1), generator=g)
    w = 1 + 0.5 * torch.randn((d,), generator=g)
    bias = 0.5 * torch.randn((d,), generator=g)
    cos, sin = rope_tables(d, s_grid, s_grid, 32, "cpu")
    return x.to(dtype), w.to(dtype), bias.to(dtype), cos, sin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_plain_is_apply_rope_of_the_plain_norm(dtype):
    """The rotary entry's plain version is the two steps it fuses, bit for
    bit: K5's plain version, then the model's ``apply_rope``."""
    from tokenflow_torch.models.hunyuan_dit import apply_rope

    x, w, b, cos, sin = _rope_inputs(2, 4, 3, 88, seed=1, dtype=dtype)
    got = tln.layer_norm_rope_plain(x, w, b, 1e-6, cos, sin)
    want = apply_rope(tln.layer_norm_plain(x, w, b, 1e-6), cos, sin)
    assert got.dtype == dtype and torch.equal(got, want)


def _emulate_rope_rows(x, w, b, eps, cos, sin, heads, seq):
    """The rotary kernel's rows in plain PyTorch: x viewed as (rows, D),
    row r normed and rotated by the tables' row (r / heads) % seq, the
    launcher's ``heads`` and ``seq``."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    pos = (torch.arange(rows.shape[0]) // heads) % seq
    y = tln.layer_norm_plain(rows, w, b, eps).float()
    pairs = y.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    out = y * cos[pos]
    out.addcmul_(rot, sin[pos])
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("fault", [None, "heads_left_out", "heads_and_seq_swapped"])
@pytest.mark.parametrize("layout", ["batch", "pivotal"])
def test_emulated_row_positions_match_apply_rope(layout, fault):
    """Row r of the (B S H, D) view sits at token (r / H) % S of its own
    image: at B = 3 images, and on the pivotal pass's (ns K, S, H, D)
    reshape of 2 streams x 3 keyframes, the emulated rows equal
    ``apply_rope`` of the plain norm bit for bit; a launcher given 1 head,
    or heads and seq swapped, does not."""
    from tokenflow_torch.models.hunyuan_dit import apply_rope

    heads, d = 4, 88
    if layout == "batch":
        x, w, b, cos, sin = _rope_inputs(3, 4, heads, d, seed=2)
    else:  # the keyframes' q (ns, K, S, H D), joined into ns K images as the DiT joins them
        x, w, b, cos, sin = _rope_inputs(6, 4, heads, d, seed=3)
        x = x.reshape(2, 3, 16, heads * d).reshape(2 * 3, 16, heads, d)
    s = x.shape[1]
    launch = {None: (heads, s), "heads_left_out": (1, s),
              "heads_and_seq_swapped": (s, heads)}[fault]
    got = _emulate_rope_rows(x, w, b, 1e-6, cos, sin, *launch)
    want = apply_rope(tln.layer_norm_plain(x, w, b, 1e-6), cos, sin)
    assert torch.equal(got, want) == (fault is None)


@pytest.mark.parametrize("d", [40, 64, 80, 88, 128, 160])
def test_rope_plan_takes_the_head_dims_of_four_lanes(d):
    """The rotary entry runs K5's plan at the head dim: 4 lanes a row, 88
    at 4 x 3, every head dim up to 160."""
    p = tln.rope_plan(d)
    assert p == tln.plan(d) and p.lanes == tln.ROPE_LANES and p.vecs <= tln.ROPE_MAX_VECS
    assert {88: (4, 3)}.get(d, tuple(p)) == tuple(p)


@pytest.mark.parametrize("d", [168, 320, 1408])
def test_rope_plan_refuses_wider_heads(d):
    with pytest.raises(NotImplementedError, match="head dims up to 160"):
        tln.rope_plan(d)


def test_rope_plan_constants_match_the_cuda_source():
    """``ROPE_LANES`` and ``ROPE_MAX_VECS`` are the source's, whose launcher
    table instantiates every vector count up to the most; the library's
    signature has the launcher's 14 arguments."""
    from tokenflow_torch.kernels import _build

    src = (Path(tln.__file__).resolve().parents[1] / "csrc" / "layer_norm.cu").read_text()
    assert int(re.search(r"constexpr int kRopeLanes = (\d+);", src).group(1)) == tln.ROPE_LANES
    assert int(re.search(r"constexpr int kRopeMaxVecs = (\d+);", src).group(1)) == (
        tln.ROPE_MAX_VECS)
    table = re.search(r"RopeKernel rope_kernel_for\(int vecs\) \{(.*?)\n\}", src, re.S).group(1)
    assert re.findall(r"case (\d+): return layer_norm_rope_kernel<(\d+)>;", table) == [
        (str(v), str(v)) for v in range(1, tln.ROPE_MAX_VECS + 1)]
    launcher = re.search(r'extern "C" int tf_layer_norm_rope\((.*?)\)', src, re.S).group(1)
    assert len(launcher.split(",")) == len(_build.SIGNATURES["tf_layer_norm_rope"]) == 14


def test_rope_wrapper_refuses_what_the_kernel_lacks():
    x, w, b, cos, sin = _rope_inputs(1, 2, 2, 88, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin)
    with pytest.raises(ValueError, match=r"\(4, 88\)"):
        tln.layer_norm_rope_kernel(x, w, b, 1e-6, cos[:3], sin[:3])
    with pytest.raises(ValueError, match="B, S, H, D"):
        tln.layer_norm_rope_kernel(x[0], w, b, 1e-6, cos, sin)


@pytest.mark.cuda
def test_rope_kernel_matches_the_two_launch_path_on_cuda():
    """The rotary entry at a DiT shape (2 images of 64^2 tokens, 16 heads of
    88) against the path it replaces, K5 then ``apply_rope`` in fp32:
    within 1 bf16 step (FMA contraction alone differs); two launches bit
    for bit; the counters. Against the all-plain version K5's own
    1-step differences pass through the rotation's cancellations, so the
    two-launch path is the yardstick (skips without a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from tokenflow_torch.models.hunyuan_dit import apply_rope

    x, w, b, cos, sin = (t.cuda() for t in _rope_inputs(2, 64, 16, 88, seed=5))
    before, k5 = tln.rope_launches, tln.launches
    got = tln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin)
    assert tln.rope_launches == before + 1 and tln.launches == k5
    assert torch.equal(got, tln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin))
    two = apply_rope(tln.layer_norm_kernel(x, w, b, 1e-6), cos, sin)
    assert _bf16_steps(got.cpu(), two.cpu()) <= 1.0

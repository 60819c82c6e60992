"""K6's module (``tokenflow_torch/kernels/short_attention.py``): the dispatch
rule of ``ops/attention.py::flash_attention`` at or under ``kv_block``, the
wrapper's refusals, the kernel's two plans emulated against the plain
version, guards on the CUDA source, and (on a card only) the kernel against
``sdp_attention`` in fp32.

Limits: K1's (``chip_smoke.py``), max|err| at most 4 bf16 steps at the
reference's largest |output| and relative L2 at most 5e-3 against
``sdp_attention`` on fp32 copies of the bf16 inputs. The kernel rounds P to
bf16 (as ``sdp_attention`` does on a bf16 stack) and O to bf16, which the
fp32 reference does not: about 2e-3 relative L2.
"""

import importlib.util
import math
import re
import sys
from pathlib import Path

import pytest
import torch

from tokenflow_torch import profiling
from tokenflow_torch.kernels import _build
from tokenflow_torch.kernels import flash_attention as tfa
from tokenflow_torch.kernels import short_attention as tsa
from tokenflow_torch.ops import attention as tatt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tokenflow_torch" / "csrc" / "short_attention.cu"
MAX_ULPS, REL_L2 = 4, 5e-3


def _qkv(b, sq, skv, h, d, seed, dtype=torch.bfloat16, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((b, s, h, d), generator=g).to(device=device, dtype=dtype)
                 for s in (sq, skv, skv))


def _mismatch(out, ref):
    """max|err| in bf16 steps at ref's largest |value|, and relative L2."""
    o, r = out.float(), ref.float()
    step = 2.0 ** (math.floor(math.log2(float(r.abs().max()))) - 7)
    return float((o - r).abs().max()) / step, float((o - r).norm() / r.norm())


def _within(out, ref):
    ulps, rel = _mismatch(out, ref)
    return ulps <= MAX_ULPS and rel <= REL_L2


# ---------------------------------------------------------------- dispatch


class _Fake:
    """What the dispatch reads of a tensor: device, dtype and shape."""

    def __init__(self, shape, dtype, cuda):
        self.shape, self.dtype, self.is_cuda = torch.Size(shape), dtype, cuda
        self.device = torch.device("cuda" if cuda else "cpu")


@pytest.fixture
def routes(monkeypatch):
    """Stubs for K6's launcher, K1's and the plain version: each records
    the calls it takes and returns its own name."""
    taken = []

    def stub(name):
        def call(q, k, v, **kw):
            taken.append((name, kw, profiling._record is not None and any(
                s is None for s in profiling._record.spans)))
            return name
        return call

    monkeypatch.setattr(tsa, "short_attention_kernel", stub("k6"))
    monkeypatch.setattr(tatt, "sdp_attention", stub("plain"))
    monkeypatch.setattr(tatt, "flash_attention_kernel", stub("k1"))
    monkeypatch.setattr(tatt, "flash_attention_plain", stub("k1_plain"))
    monkeypatch.setattr(tatt, "plain_on_cuda", 0)
    return taken


BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("case,want,counted", [
    (dict(d=40), "k6", 0), (dict(d=64), "k6", 0), (dict(d=80), "k6", 0),
    (dict(d=160), "k6", 0), (dict(d=64, skv=1024), "k6", 0), (dict(d=64, skv=64), "k6", 0),
    (dict(d=64, dtypes=(F32, F32, F32)), "plain", 1),
    (dict(d=64, dtypes=(F16, F16, F16)), "plain", 1),
    (dict(d=512), "plain", 1),
    (dict(d=32), "plain", 1),
    (dict(d=64, dtypes=(BF16, F32, F32)), "plain", 1),
    (dict(d=64, dtypes=(BF16, BF16, F32)), "plain", 1),
    (dict(d=64, cuda=False), "plain", 0),
    (dict(d=64, skv=1025), "k1", 0),
    (dict(d=64, skv=1025, cuda=False), "k1_plain", 0),
], ids=lambda x: str(x))
def test_dispatch_rule(routes, case, want, counted):
    """CUDA, bf16 q/k/v, D in K6's head dims and Skv <= kv_block go to K6,
    inside a tf.sdp span; every other short-key call to sdp_attention, the
    CUDA ones counted in plain_on_cuda; longer keys to K1 or its plain
    version as before."""
    d, skv, cuda = case["d"], case.get("skv", 77), case.get("cuda", True)
    dq, dk, dv = case.get("dtypes", (BF16, BF16, BF16))
    q = _Fake((2, 256, 5, d), dq, cuda)
    k, v = _Fake((2, skv, 5, d), dk, cuda), _Fake((2, skv, 5, d), dv, cuda)
    with profiling.spans() as record:
        got = tatt.flash_attention(q, k, v, kv_block=1024)
    assert got == want and [t[0] for t in routes] == [want]
    assert tatt.plain_on_cuda == counted
    if want == "k6":
        assert routes[0][1] == {"scale": None, "kv_block": 1024}
        assert routes[0][2], "K6 launched outside an open span"
        assert [s.name for s in record.spans] == ["tf.sdp"]


def test_flash_attention_on_cpu_never_loads_or_launches_k6(monkeypatch):
    """CPU tensors at every K6 head dim and key length take sdp_attention
    bit for bit: the kernel library is never loaded and K6 never counts a
    launch."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was loaded on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    launches, plain = tsa.launches, tatt.plain_on_cuda
    for d in tsa.HEAD_DIMS:
        for skv in (64, 77, 256, 1024):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = _qkv(1, 70, skv, 2, d, seed=d + skv, dtype=dtype)
                got = tatt.flash_attention(q, k, v, kv_block=1024)
                assert torch.equal(got, tatt.sdp_attention(q, k, v))
    assert tsa.launches == launches and tatt.plain_on_cuda == plain


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA device"),
    ("fp32", NotImplementedError, "bf16"),
    ("fp16", NotImplementedError, "bf16"),
    ("d512", NotImplementedError, "head dims"),
    ("long", ValueError, "exceed kv_block"),
    ("mixed", NotImplementedError, "bf16"),
    ("shapes", ValueError, "disagree"),
])
def test_wrapper_refuses(case, error, match):
    """The wrapper raises on what the kernel does not take; none of these
    reaches the library (the CPU build has none)."""
    d = 512 if case == "d512" else 64
    dtype = {"fp32": torch.float32, "fp16": torch.float16}.get(case, torch.bfloat16)
    q, k, v = _qkv(1, 16, 1025 if case == "long" else 77, 2, d, seed=1, dtype=dtype)
    if case == "mixed":
        k = k.float()
    if case == "shapes":
        q = q[:, :, :1]
    with pytest.raises(error, match=match):
        tsa.short_attention_kernel(q, k, v)


def test_plan_by_key_length():
    assert [tsa.plan(s) for s in (1, 64, 77, 80, 128, 129, 144, 1024)] == [
        "one_tile"] * 5 + ["streamed"] * 3


# ------------------------------------------------------- the CUDA source


def _kernel_names(src: str) -> list[str]:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)


def test_kernel_names_stay_apart_from_k1_and_the_match_core(monkeypatch):
    """The benchmark counts K1 by kernels whose names hold ``flash_fwd`` and
    the match core by ``match_core``; K6's names hold neither, and the
    yardstick files them as ``other``."""
    names = _kernel_names(SOURCE.read_text())
    assert names == ["short_attn_fwd"]
    spec = importlib.util.spec_from_file_location(
        "k6_test_yardstick", ROOT / "benchmark" / "yardstick.py")
    yardstick = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, yardstick)
    spec.loader.exec_module(yardstick)
    for name in names:
        assert "flash_fwd" not in name and "match_core" not in name
        assert yardstick.kernel_class(f"(anonymous namespace)::{name}<64, 80, true>") == "other"


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()
    launcher = re.search(r'extern "C" int tf_short_attention\((.*?)\n\}', src, re.S).group(1)
    assert tuple(int(n) for n in re.findall(r"case (\d+):", launcher)) == tsa.HEAD_DIMS
    one_tile = re.findall(r"if \(skv <= (\d+)\) return launch<D, \d+, true>", src)
    assert [int(n) for n in one_tile] == [64, 80, tsa.ONE_TILE_KEYS]
    assert tsa.HEAD_DIMS == tfa.HEAD_DIMS
    assert "tf_short_attention" in _build.SIGNATURES


# ------------------------------------------------- the plans, emulated


def _emulate(q, k, v, fault=None):
    """K6's arithmetic in plain PyTorch on bf16 inputs: fp32 logits; one
    tile (Skv <= 128): the row padded to 64, 80 or 128 keys, the pad masked,
    P normalised in fp32 then cast to bf16; streamed: 128-key tiles, K1's
    online softmax with unnormalised bf16 P and one division at the end.
    ``fault``: "no_mask" leaves the pad's zero keys unmasked,
    "v_to_8_bits" multiplies P V with V rounded to multiples of 1/8."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    if fault == "v_to_8_bits":
        vf = (vf * 8).round() / 8
    if tsa.plan(skv) == "one_tile":
        n = next(n for n in (64, 80, 128) if skv <= n)
        kp = torch.zeros((b, n, h, d)).index_copy(1, torch.arange(skv), kf)
        vp = torch.zeros((b, n, h, d)).index_copy(1, torch.arange(skv), vf)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kp) * scale
        if fault != "no_mask":
            s[..., skv:] = float("-inf")
        p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
        return torch.einsum("bhqk,bkhd->bqhd", p, vp).to(torch.bfloat16)
    acc = torch.zeros((b, h, sq, d))
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    for j in range(0, skv, 128):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, j:j + 128]) * scale
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                                     vf[:, j:j + 128])
        m = mn
    return (acc / l).permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("skv", [64, 77, 144, 256, 1024])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_emulated_plans_meet_the_limits(skv, d):
    """Both plans' arithmetic within the limits of sdp_attention in fp32."""
    q, k, v = _qkv(1, 100, skv, 2, d, seed=skv * d)
    ref = tatt.sdp_attention(q.float(), k.float(), v.float())
    assert _within(_emulate(q, k, v), ref), _mismatch(_emulate(q, k, v), ref)


@pytest.mark.parametrize("fault", ["no_mask", "v_to_8_bits"])
def test_emulated_faults_break_the_limits(fault):
    """The limits see an unmasked pad (77 keys in an 80-key tile) and a
    coarse V: both read above them."""
    q, k, v = _qkv(2, 128, 77, 2, 64, seed=5)
    ref = tatt.sdp_attention(q.float(), k.float(), v.float())
    assert _within(_emulate(q, k, v), ref)
    assert not _within(_emulate(q, k, v, fault), ref), _mismatch(_emulate(q, k, v, fault), ref)


# ------------------------------------------------------------ on a card


@pytest.mark.cuda
def test_kernel_matches_sdp_attention_on_cuda():
    """K6 against sdp_attention on fp32 copies at 77, 64, 256 and 1024 keys,
    D = 40, 64, 80 and 160, one ragged Sq and strided (head-split) views;
    two launches bitwise equal; the counters (skips without a GPU;
    chip_smoke.py's [K6] rows cover the paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cases = [(b, sq, skv, h, d) for d in tsa.HEAD_DIMS
             for b, sq, skv, h in ((3, 256, 77, 5), (2, 64, 64, 8), (2, 256, 256, 4),
                                   (1, 1024, 1024, 2))]
    cases.append((3, 333, 77, 5, 64))  # ragged Sq
    cases.append((2, 1000, 700, 3, 80))  # ragged Sq and a ragged streamed tail
    for b, sq, skv, h, d in cases:
        q, k, v = _qkv(b, sq, skv, h, d, seed=sq + skv + d, device="cuda")
        before = tsa.launches
        got = tsa.short_attention_kernel(q, k, v)
        again = tsa.short_attention_kernel(q, k, v)
        ref = tatt.sdp_attention(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        assert tsa.launches == before + 2
        assert tsa.launches_by_shape[(b, sq, skv, h, d)] >= 2
        assert torch.equal(got, again)
        assert _within(got, ref), ((b, sq, skv, h, d), _mismatch(got, ref))
    # head-split views of (B, S, H * D) projections, as the models pass them
    x = torch.randn((4, 300, 3 * 5 * 64), device="cuda").bfloat16()
    q, k, v = (t.reshape(4, 300, 5, 64) for t in x.chunk(3, dim=-1))
    ref = tatt.sdp_attention(q.float(), k[:, :77].float(), v[:, :77].float())
    assert _within(tsa.short_attention_kernel(q, k[:, :77], v[:, :77]), ref)

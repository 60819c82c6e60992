"""Port parity for K1's module: tokenflow_torch.ops.attention and
ops.extended_attention against the JAX ops, and the K1 dispatch rule.

Tolerance: fp32 on both sides, atol 1e-5 / rtol 1e-5 (the blockwise
online softmax sums in the same block order; only the matmul summation
order differs). The Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import flash_attention as tfa
from tokenflow_torch.kernels._operands import tma_operand
from tokenflow_torch.ops import attention as tatt
from tokenflow_torch.ops import extended_attention as text
from tokenflow_tpu.kernels.flash_attention import flash_attention_bhsd
from tokenflow_tpu.ops import attention as jatt
from tokenflow_tpu.ops import extended_attention as jext

torch.set_num_threads(2)

ATOL = RTOL = 1e-5


def _pair(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def test_split_merge_heads_roundtrip():
    x, xj = _pair((2, 5, 12), 0)
    s = tatt.split_heads(x, 3)
    _close(s, jatt.split_heads(xj, 3))
    assert torch.equal(tatt.merge_heads(s), x)


@pytest.mark.parametrize("sq,skv", [(16, 16), (24, 40), (7, 100)])
def test_sdp_attention_matches_jax(sq, skv):
    q, qj = _pair((2, sq, 3, 16), 1)
    k, kj = _pair((2, skv, 3, 16), 2)
    v, vj = _pair((2, skv, 3, 16), 3)
    _close(tatt.sdp_attention(q, k, v), jatt.sdp_attention(qj, kj, vj))


@pytest.mark.parametrize(
    "sq,skv,kv_block,d",
    [pytest.param(*c, 16, id="-".join(map(str, c)))
     for c in [(16, 48, 16), (33, 100, 32), (64, 64, 16), (10, 30, 64), (20, 70, 70)]]
    + [pytest.param(33, 100, 32, d, id=f"33-100-32-d{d}") for d in (40, 80, 160)],
)
def test_flash_attention_matches_jax_scan(sq, skv, kv_block, d):
    """Skv > kv_block runs the blockwise plain version (ragged last block
    included); Skv <= kv_block takes the dense shortcut on both sides."""
    q, qj = _pair((2, sq, 3, d), 4)
    k, kj = _pair((2, skv, 3, d), 5)
    v, vj = _pair((2, skv, 3, d), 6)
    got = tatt.flash_attention(q, k, v, kv_block=kv_block)
    want = jatt.flash_attention(qj, kj, vj, kv_block=kv_block)
    _close(got, want)


@pytest.mark.parametrize(
    "sq,skv,d",
    [pytest.param(32, 100, 16, id="32-100"), pytest.param(24, 64, 16, id="24-64")]
    # SD-1.5's head dims (K1's D = 40, 80, 160), ragged KV tail included
    + [pytest.param(32, 100, d, id=f"32-100-d{d}") for d in (40, 80, 160)],
)
def test_flash_plain_matches_pallas_interpret(sq, skv, d):
    q, qj = _pair((2, sq, 3, d), 7)
    k, kj = _pair((2, skv, 3, d), 8)
    v, vj = _pair((2, skv, 3, d), 9)
    want = flash_attention_bhsd(
        qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        scale=d**-0.5, bq=16, bk=32, interpret=True,
    ).transpose(0, 2, 1, 3)
    _close(tfa.flash_attention_plain(q, k, v, kv_block=32), want)


def test_flash_plain_bf16_is_close_to_fp32():
    q, _ = _pair((1, 40, 2, 64), 10)
    k, _ = _pair((1, 90, 2, 64), 11)
    v, _ = _pair((1, 90, 2, 64), 12)
    lo = tfa.flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_block=32)
    assert lo.dtype == torch.bfloat16
    hi = tfa.flash_attention_plain(q, k, v, kv_block=32)
    assert (lo.float() - hi).abs().max() < 2e-2


@pytest.mark.parametrize(
    "d,dtype", [(48, torch.bfloat16), (128, torch.bfloat16), (40, torch.float16),
                (64, torch.float16)],
)
def test_kernel_wrapper_rejects_other_head_dims_and_dtypes(d, dtype):
    """K1 is instantiated for bf16 at D = 40, 64, 80, 88, 160 and for fp32
    at D = 40, 64, 80, 160; anything else (another head dim, fp16) raises
    before a launch (no fallback)."""
    assert tfa.HEAD_DIMS == (40, 64, 80, 88, 160)
    assert tfa.HEAD_DIMS_F32 == (40, 64, 80, 160)
    q = torch.zeros(1, 8, 1, d, dtype=dtype)
    with pytest.raises(NotImplementedError, match="head dim"):
        tfa.flash_attention_kernel(q, q, q)


def test_kernel_wrapper_rejects_cpu_tensors():
    """CPU tensors take the plain version only through the dispatch; the
    kernel wrapper itself never runs anything but the CUDA kernel."""
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kernel(q, q, q)


def _operand_case(case):
    base = torch.zeros(3, 16, 320, dtype=torch.bfloat16)
    if case == "contiguous":
        return torch.zeros(2, 16, 5, 64, dtype=torch.bfloat16), True
    if case == "head_split_view":  # ext() of ops/extended_attention.py
        return base[1:].reshape(2, 16, 5, 64), True
    if case == "broadcast":  # the injected source-stream q/k
        return base[:1].expand(3, 16, 320)[1:].reshape(2, 16, 5, 64), False
    if case == "stride_not_16_bytes":
        return torch.zeros(2, 16, 5, 68, dtype=torch.bfloat16)[..., :64], False
    assert case == "base_not_16_bytes"
    return torch.zeros(2 * 16 * 5 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 5, 64), False


@pytest.mark.parametrize(
    "case",
    ["contiguous", "head_split_view", "broadcast", "stride_not_16_bytes",
     "base_not_16_bytes"],
)
def test_kernel_operand_meets_tma_rules(case):
    """K1's TMA tensor maps need a 16-byte aligned base and byte strides
    that are positive multiples of 16: other tensors are copied first,
    views that meet the rules are passed as they are."""
    t, kept = _operand_case(case)
    got = tma_operand(t)
    assert torch.equal(got, t)
    assert (got.data_ptr() == t.data_ptr()) is kept
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    assert all(s > 0 and s % 8 == 0 for s in got.stride()[:3])


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "case,passes",
    [("other_block_order", True), ("exact_fp64_rounded", True),
     ("tail_as_zero_logits", False), ("last_tile_dropped", False)],
)
def test_k1_limits_separate_right_from_wrong(case, passes):
    """chip_smoke.py's K1 limits at its ragged row (1000 x 3000, K1's KV
    tiles of 128 tokens): outputs with K1's numerics in another block order,
    or the exact softmax rounded to bf16, pass; a KV tail that takes TMA's
    zero-filled rows as logit 0 (72 of them) instead of masking them, or a
    last KV tile left out, fail."""
    smoke = _chip_smoke()
    b, sq, skv, h = smoke.K1_SHAPES[-1]
    assert (sq, skv) == (1000, 3000)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, n, h, 64), generator=g).bfloat16() for n in (sq, skv, skv))
    ref = tfa.flash_attention_plain(q, k, v, kv_block=1024)
    tile = 128
    if case == "other_block_order":
        out = tfa.flash_attention_plain(q, k, v, kv_block=tile)
    elif case == "exact_fp64_rounded":
        out = torch.nn.functional.scaled_dot_product_attention(
            *(x.double().transpose(1, 2) for x in (q, k, v))
        ).transpose(1, 2).bfloat16()
    elif case == "tail_as_zero_logits":
        pad = k.new_zeros(b, -skv % tile, h, 64)
        out = tfa.flash_attention_plain(
            q, torch.cat([k, pad], 1), torch.cat([v, pad], 1), kv_block=tile
        )
    else:
        kept = skv - skv % tile
        out = tfa.flash_attention_plain(q, k[:, :kept], v[:, :kept], kv_block=tile)
    m = smoke.k1_mismatch(out, ref)
    print(case, m)
    assert smoke.k1_within_limits(m) is passes, m


@pytest.mark.parametrize("gate", [None, False, True])
@pytest.mark.parametrize("kv_block", [16, 1024])
def test_extended_attention_matches_jax(gate, kv_block):
    heads = 2
    q, qj = _pair((3, 2, 12, 16), 13)
    k, kj = _pair((3, 2, 12, 16), 14)
    v, vj = _pair((3, 2, 12, 16), 15)
    qi, ki = text.inject_source_qk(q, k, gate)
    qij, kij = jext.inject_source_qk(
        qj, kj, None if gate is None else jnp.asarray(gate)
    )
    _close(qi, qij)
    _close(ki, kij)
    got = text.extended_attention(qi, ki, v, heads=heads, kv_block=kv_block)
    want = jext.extended_attention(qij, kij, vj, heads=heads, kv_block=kv_block)
    _close(got, want)
    if gate:
        # injected: uncond and cond streams carry the source q/k
        assert torch.equal(qi[1], q[0]) and torch.equal(ki[2], k[0])


def test_extended_attention_two_streams():
    q, qj = _pair((2, 3, 8, 16), 16)
    k, kj = _pair((2, 3, 8, 16), 17)
    v, vj = _pair((2, 3, 8, 16), 18)
    _close(
        text.extended_attention(q, k, v, heads=4, kv_block=8),
        jext.extended_attention(qj, kj, vj, heads=4, kv_block=8),
    )


@pytest.mark.cuda
def test_kernel_launch_on_cuda():
    """K1 against its plain version on the card (skips without a GPU;
    chip_smoke.py covers the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn((2, n, 3, 64), generator=g, device="cuda").bfloat16()
        for n in (100, 300, 300)
    )
    before = tfa.launches
    out = tatt.flash_attention(q, k, v, kv_block=64)
    assert tfa.launches == before + 1
    ref = tfa.flash_attention_plain(q, k, v, kv_block=64)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2

"""Port parity for K4's module: ``group_norm_plain`` against the JAX
GroupNorm reference (``group_norm_ref``) and the Pallas kernel
(``group_norm_nhwc`` in interpret mode, both layouts, as
tests/test_kernels.py runs it), and the ``FusedGroupNorm`` switch.

Inputs are NHWC, made with numpy, and permuted to NCHW for the port.
Tolerances: fp32 rtol/atol 1e-5 (sums in another order, ~1e-7 relative on
the statistics); bf16 at most 1 bf16 step, counted at max(|ref|, 2^-6)
(near zero the fp32 rounding of the affine's terms exceeds a bf16 step of
the tiny result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import group_norm as tgn
from tokenflow_torch.models.layers import FusedGroupNorm
from tokenflow_tpu.kernels.group_norm import group_norm_nhwc, group_norm_ref

torch.set_num_threads(2)


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    b, hh, ww, c = shape
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = (1 + 0.5 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    if dtype == "bf16":  # round once, feed both sides the same values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, eps, act, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(tdt)
    y = tgn.group_norm_plain(
        x, torch.from_numpy(scale), torch.from_numpy(bias), groups, eps, act
    )
    assert y.dtype == tdt
    return y.float().permute(0, 2, 3, 1).numpy()


def _bf16_steps(got, want, floor=2.0**-6):
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _check(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("layout", ["bl", "cl"])
def test_plain_matches_ref_and_pallas_interpret(layout, act, dtype):
    b, hh, ww, c, g = 3, 8, 8, 32, 8
    x, scale, bias = _inputs((b, hh, ww, c), seed=3, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    got = _port(x, scale, bias, g, 1e-5, act, dtype)
    ref = group_norm_ref(
        xj.reshape(b, -1, c), jnp.asarray(scale), jnp.asarray(bias),
        groups=g, eps=1e-5, act=act,
    ).reshape(x.shape)
    _check(got, ref, dtype)
    pallas = group_norm_nhwc(
        xj, jnp.asarray(scale), jnp.asarray(bias), groups=g, eps=1e-5, act=act,
        layout=layout, interpret=True,
    )
    _check(got, pallas, dtype)


@pytest.mark.parametrize("shape,g", [((2, 16, 16, 96), 32), ((3, 7, 9, 96), 32)])
def test_plain_matches_ref_more_shapes(shape, g):
    """Many channels per group and a ragged spatial extent (63 per channel),
    bf16 with SiLU and the transformer norms' eps."""
    x, scale, bias = _inputs(shape, seed=4, dtype="bf16")
    got = _port(x, scale, bias, g, 1e-6, "silu", "bf16")
    ref = group_norm_ref(
        jnp.asarray(x, jnp.bfloat16).reshape(shape[0], -1, shape[-1]),
        jnp.asarray(scale), jnp.asarray(bias), groups=g, eps=1e-6, act="silu",
    ).reshape(shape)
    _check(got, ref, "bf16")


def test_fused_group_norm_switch():
    """use_kernel off is the F.group_norm path, unchanged; on (CPU tensor)
    is the plain version."""
    torch.manual_seed(0)
    m = FusedGroupNorm(8, 32, eps=1e-5, act="silu")
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    x = torch.randn(2, 32, 5, 5)
    assert m.use_kernel is False
    off = m(x)
    want = torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, 8, m.weight, m.bias, 1e-5)
    )
    assert torch.equal(off, want)
    m.use_kernel = True
    on = m(x)
    assert torch.equal(on, tgn.group_norm_plain(x, m.weight, m.bias, 8, 1e-5, "silu"))
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_rejects_cpu_tensors():
    x, w = torch.randn(2, 32, 4, 4).bfloat16(), torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_kernel(x, w, w, 8, 1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K4 against its plain version on the card, resident and split spans,
    ragged extents (skips without a GPU; chip_smoke.py covers the SDEdit
    path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(3, 96, 7, 9), (2, 64, 40, 40), (2, 64, 300, 301)]:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = torch.randn((shape[1],), generator=gen, device="cuda").bfloat16()
        b = torch.randn((shape[1],), generator=gen, device="cuda").bfloat16()
        for act in (None, "silu"):
            before = tgn.launches
            got = tgn.group_norm_kernel(x, w, b, 32, 1e-5, act)
            assert tgn.launches == before + 1
            want = tgn.group_norm_plain(x, w, b, 32, 1e-5, act)
            assert _bf16_steps(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 2
    with pytest.raises(NotImplementedError, match="bf16"):
        tgn.group_norm_kernel(x.float(), w, b, 32, 1e-5)

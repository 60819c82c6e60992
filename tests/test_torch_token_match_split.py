"""Port parity for K3's module: ``token_match_gather_split_plain`` against
the JAX ``token_match_gather_split`` in interpret mode, the K2/K3 choice
(``use_split``) against the JAX dispatch, and the propagation op's routing.

Inputs are well separated (each pivot table holds permuted, slightly
perturbed copies of the query rows), so the matched indices must be
identical. The JAX kernel returns only the blended output, so its indices
are read back through it: a keyframe table whose first column holds the
token index (exact in fp32), gathered with w1 = 1 (pivot pa only, ia) and
w1 = 0 (pivot pb only, ib). Outputs: atol 1e-6 (fp32 rounding of the
blend).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import token_match_split as tms
from tokenflow_torch.ops import propagation as tprop
from tokenflow_tpu.kernels.token_match import fits_vmem
from tokenflow_tpu.kernels.token_match_split import token_match_gather_split
from tokenflow_tpu.ops import propagation as jprop

torch.set_num_threads(2)

ATOL = 1e-6


def _separated(f, k, s, d, ns=3, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((s, d))
    x = base[rng.integers(0, s, (f, s))] + 0.01 * rng.standard_normal((f, s, d))
    p = np.stack([base[rng.permutation(s)] for _ in range(k)])
    p = p + 0.01 * rng.standard_normal(p.shape)
    p_hat = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)
    kf = rng.standard_normal((ns, k, s, d))
    pa, pb, w1 = jprop.propagation_indices(f, f // k)
    return [a.astype(np.float32) for a in (x, p_hat, kf)] + [pa, pb, w1]


def _jax_split(x, p_hat, kf, pa, pb, w1):
    return np.asarray(token_match_gather_split(
        *(jnp.asarray(a) for a in (x, p_hat, kf, pa, pb, w1)),
        bq_match=128, bz=128, bq_gather=128, interpret=True,
    ))


@pytest.mark.parametrize("f,k,s,d", [(4, 2, 256, 16), (6, 3, 128, 24)])
def test_split_plain_matches_jax_interpret(f, k, s, d):
    x, p_hat, kf, pa, pb, w1 = _separated(f, k, s, d, seed=s + d)
    out, ia, ib = tms.token_match_gather_split_plain(
        *(torch.from_numpy(a) for a in (x, p_hat, kf, pa, pb, w1)),
        return_indices=True,
    )
    assert ia.shape == ib.shape == (f, 1, s) and ia.dtype == torch.int32
    np.testing.assert_allclose(
        out.numpy(), _jax_split(x, p_hat, kf, pa, pb, w1), rtol=0, atol=ATOL
    )
    # the JAX kernel's indices, read back through an index-valued table
    kf_idx = np.zeros_like(kf)
    kf_idx[..., 0] = np.arange(s, dtype=np.float32)
    ones, zeros = np.ones_like(w1), np.zeros_like(w1)
    ja = _jax_split(x, p_hat, kf_idx, pa, pb, ones)[0, :, :, 0]
    jb = _jax_split(x, p_hat, kf_idx, pa, pb, zeros)[0, :, :, 0]
    assert np.array_equal(ia[:, 0].numpy(), ja.astype(np.int32))
    assert np.array_equal(ib[:, 0].numpy(), jb.astype(np.int32))
    assert torch.equal(
        tms.token_match_gather_split_plain(
            *(torch.from_numpy(a) for a in (x, p_hat, kf, pa, pb, w1))
        ),
        out,
    )


@pytest.mark.parametrize("ns", [3, 2])
@pytest.mark.parametrize(
    "s,d",
    [
        (4096, 320), (1024, 640), (256, 1280), (64, 1280),  # 512^2 sites
        (9216, 320), (2304, 640), (576, 1280), (144, 1280),  # 768p sites
    ],
)
def test_use_split_follows_the_jax_dispatch(s, d, ns):
    """K3 exactly where the JAX dispatch leaves K2 (fits_vmem false)."""
    assert tms.use_split(s, d, ns) == (not fits_vmem(s, d, ns=ns))


def test_use_split_at_768p_only():
    assert tms.use_split(9216, 320) and not tms.use_split(4096, 320)
    assert tms.SPLIT_KF_TABLE_BYTES == 12 << 20


def test_kernel_wrapper_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _separated(4, 2, 64, 8, seed=3)]
    with pytest.raises(ValueError, match="CUDA"):
        tms.token_match_gather_split_kernel(*args)


@pytest.mark.cuda
def test_kernel_matches_plain_and_k2_on_cuda():
    """K3 against its plain version and against K2 on the card, and the
    propagation op's routing at a K3 site (skips without a GPU;
    chip_smoke.py covers the 768p shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from tokenflow_torch.kernels import token_match as tm

    x, p_hat, kf, pa, pb, w1 = _separated(8, 2, 200, 64, seed=4)
    args = [torch.from_numpy(a).cuda() for a in (x, p_hat, kf, pa, pb, w1)]
    for i in range(3):
        args[i] = args[i].bfloat16()
    before = tms.launches
    out, ia, ib = tms.token_match_gather_split_kernel(*args, return_indices=True)
    assert tms.launches == before + 1
    ref, ref_ia, ref_ib = tms.token_match_gather_split_plain(*args, return_indices=True)
    assert torch.equal(ia, ref_ia) and torch.equal(ib, ref_ib)
    assert torch.equal(out, ref)
    k2_out = tm.token_match_gather_kernel(*args)
    assert torch.equal(k2_out, out)
    args[3] = torch.full_like(args[3], 2)  # K = 2 pivots: index 2 is out of range
    with pytest.raises(IndexError, match="pivot indices"):
        tms.token_match_gather_split_kernel(*args)
    # a 768p top-level site routes to K3
    s, d = 9216, 320
    norm_h = torch.randn((2, s, d), device="cuda").bfloat16()
    piv = torch.randn((1, s, d), device="cuda").bfloat16()
    kft = torch.randn((3, 1, s, d), device="cuda").bfloat16()
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    before_k2, before_k3 = tm.launches, tms.launches
    tprop.token_propagation(norm_h, piv, kft, zero, zero, torch.ones(2, device="cuda"))
    assert (tm.launches, tms.launches) == (before_k2, before_k3 + 1)

"""chip_smoke.py's fp32 token-match verdict on random inputs, on the CPU.

A matched index that the kernel resolves otherwise than the plain version
is a near tie when the two pivot rows' similarities lie within
``REF_TIE_TOL`` * |x| of each other (``flip_gaps``, fp64 from the inputs);
given the inputs, ``_match_verdict`` leaves such flips out of the share it
holds to ``K2_F32_MAX_FLIP_SHARE``, and counts every other flip as before.
The kernel's side is planted here: the plain version's indices with one
token moved to another row.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tokenflow_torch.kernels import token_match as ttm

torch.set_num_threads(2)

F, S, D, K = 8, 64, 64, 2  # 2 x 8 x 64 = 1024 indices: one flip is ~1e-3 of them


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _planted(smoke, kind):
    """Random fp32 inputs, the plain version's output and indices, and the
    indices with token 0 of frame 0 moved against pivot a: to a copy of its
    row scaled by 1 - 2e-6 (``near_tie``: a gap of about 2e-6 |x|) or to its
    least similar row (``clear``)."""
    gen = torch.Generator().manual_seed(3)
    x, p_hat, kf, pa, pb, w1 = smoke._match_inputs(gen, S, D, "random", F, K,
                                                   device="cpu", dtype=torch.float32)
    _, idx = ttm.token_match_gather_plain(x, p_hat, kf, pa, pb, w1, return_indices=True)
    row = int(idx[0, 0, 0])
    table = p_hat[pa[0].long()]
    if kind == "near_tie":
        other = (row + 1) % S
        p_hat[pa[0].long(), other] = table[row] * (1 - 2e-6)
    else:
        other = int((table @ x[0, 0]).argmin())
    ref, ref_idx = ttm.token_match_gather_plain(x, p_hat, kf, pa, pb, w1,
                                                return_indices=True)
    assert int(ref_idx[0, 0, 0]) == row != other
    got = ref_idx.clone()
    got[0, 0, 0] = other
    return (x, p_hat, pa, pb), kf, ref, ref_idx.long(), got


@pytest.mark.parametrize("kind", ["near_tie", "clear"])
def test_flip_gaps_against_numpy(kind):
    smoke = _chip_smoke()
    (x, p_hat, pa, pb), _, _, ref_idx, got = _planted(smoke, kind)
    gaps = smoke.flip_gaps(x, p_hat, pa, pb, got, ref_idx)
    xn = x[0, 0].double().numpy()
    table = p_hat[pa[0].long()].double().numpy()
    want = abs(table[ref_idx[0, 0, 0]] @ xn - table[got[0, 0, 0]] @ xn) / np.linalg.norm(xn)
    assert gaps.shape == (1,) and gaps.dtype == torch.float64
    # fp64 sums in another order: ~1e-16 of the similarities (|x| ~ 8)
    np.testing.assert_allclose(float(gaps[0]), want, rtol=0, atol=1e-13)
    if kind == "near_tie":
        assert float(gaps[0]) <= smoke.REF_TIE_TOL
    else:
        assert float(gaps[0]) > 100 * smoke.REF_TIE_TOL


@pytest.mark.parametrize(
    "kind,mode,with_inputs,passes",
    [("near_tie", "random", True, True),
     ("near_tie", "negative", True, True),
     ("near_tie", "random", False, False),  # without the inputs every flip counts
     ("near_tie", "separated", True, False),  # separated inputs allow no flip
     ("clear", "random", True, False)],
)
def test_fp32_verdict_leaves_out_near_ties_only(kind, mode, with_inputs, passes):
    smoke = _chip_smoke()
    inputs, kf, ref, ref_idx, got = _planted(smoke, kind)
    assert 1 / got.numel() > smoke.K2_F32_MAX_FLIP_SHARE
    args = ("[test]", mode, got, ref_idx, ref.clone(), ref)
    kw = {"kf_max": float(kf.abs().max()), "inputs": inputs if with_inputs else None}
    if passes:
        line, flipped, _ = smoke._match_verdict(*args, **kw)
        assert flipped == 1 / got.numel() and "near ties 1 of 1 flips" in line
    else:
        with pytest.raises(AssertionError):
            smoke._match_verdict(*args, **kw)

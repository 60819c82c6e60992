"""HunyuanDiT on the port (``models/hunyuan_dit.py``), held to the
benchmark's plain reference (``benchmark/reference/hunyuan_dit.py``: plain
torch, fp32, written from diffusers' ``HunyuanDiT2DModel``) on the port's
``tiny_dit()`` preset on the CPU in fp32 with seeded random weights (6
blocks, two long skips). The JAX package has no DiT, so the reference is
the benchmark's.

- plain, PIVOTAL and PROPAGATE calls against the reference's, the caches
  entry for entry;
- the long skips' order (block 4 takes block 1's output, block 5 block
  0's), the learned-sigma split, the 2-D RoPE against its closed form and at
  a 2 x 2 grid by hand, the pool against ``F.multi_head_attention_forward``
  and the text padding under a mask;
- v-prediction in the loop: one SDEdit step (``tokenflow_sample_loop``,
  ``vanilla_sample_loop``) and one inversion step (``ddim_inversion``) of a
  model whose output is the exact v of its sample against the benchmark
  reference's steps (``reference/steps.py``), and the eps path bit for bit
  what it was; the save grid at offsets 0 and 1;
- the kernel plans the DiT adds: K1 and K6 at D = 88, the match core at
  1408 wide (three stages), K5 at 88, 1408 and 2816, with the plans of the
  existing shapes unchanged; CUDA rows skip without a card;
- the q/k transform: on the CPU the norms and ``apply_rope`` bit for bit;
  with the norms' path forced to "kernel", every rotated q and k (4 a block
  an edit step) goes to K5's rotary entry and the cross attention's k to
  ``norm_k``.

Tolerances: fp32 on both sides with the same operations in another order
(blocked attention and matches in the reference, einsums in the port): 1e-4
relative and absolute, as the port's other parity tests hold fp32 (the
whole tiny model reads about 2e-6 on the CPU); 1e-6 for the RoPE tables
(the same fp32 products, one cos/sin of the same angle); 2e-5 for the DDIM
steps, as the benchmark's stub-model test holds them (fp32 rounding of a
few products).
"""

from __future__ import annotations

import copy
import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tokenflow_torch.diffusion import ddim, inversion
from tokenflow_torch.editing import pipeline
from tokenflow_torch.kernels import flash_attention as tfa
from tokenflow_torch.kernels import layer_norm as tln
from tokenflow_torch.kernels import short_attention as tsa
from tokenflow_torch.kernels import token_match as ttm
from tokenflow_torch.models import hunyuan_dit as H
from tokenflow_torch.ops import editctx
from tokenflow_torch.ops.propagation import propagation_indices

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmark"))

from reference import hunyuan_dit as R  # noqa: E402
from reference import model as M  # noqa: E402
from reference import schedule as ref_schedule  # noqa: E402
from reference import steps as ref_steps  # noqa: E402
from reference.precision import Precision  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = H.HunyuanDiTConfig.tiny_dit()
# the tiny preset as a transformer/config.json (the code's pool heads,
# sinusoids and RoPE base stated, as a test config may)
TINY = {"in_channels": 4, "patch_size": 2, "hidden_size": 32, "num_layers": 6,
        "num_attention_heads": 2, "mlp_ratio": 2.0, "learn_sigma": True,
        "cross_attention_dim": 32, "cross_attention_dim_t5": 16, "pooled_projection_dim": 24,
        "text_len": 77, "text_len_t5": 16, "sample_size": 8, "pool_heads": 2,
        "time_proj_dim": 32, "rope_base": 2}
SCHEDULER = {"beta_end": 0.03, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
             "num_train_timesteps": 1000, "prediction_type": "v_prediction",
             "set_alpha_to_one": False, "steps_offset": 1, "timestep_spacing": "leading"}
F_, HW, WS = 4, 8, 2  # frames, latent size, window (2 pivots)


def _random_state(model: torch.nn.Module, seed: int) -> dict:
    """The benchmark's weights: normal at 1/sqrt(fan-in), biases 0.1 z,
    norm scales 1 + 0.1 z."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if p.dim() >= 2:
            out[name] = z / np.sqrt(p[0].numel())
        elif name.endswith("bias"):
            out[name] = 0.1 * z
        else:
            out[name] = 1.0 + 0.1 * z
    return out


def _inputs(b: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, HW, HW, 4), generator=gen)
    ctx = torch.randn((b, 77, 32), generator=gen)
    t5 = torch.randn((b, 16, 16), generator=gen)
    lens, lens5 = torch.randint(1, 78, (b, 1), generator=gen), torch.randint(1, 17, (b, 1),
                                                                             generator=gen)
    mask, mask5 = torch.arange(77)[None] < lens, torch.arange(16)[None] < lens5
    return x, ctx, {"encoder_hidden_states_t5": t5, "text_embedding_mask": mask.long(),
                    "text_embedding_mask_t5": mask5.long()}


def _ref_kw(added: dict) -> dict:
    return {"t5": added["encoder_hidden_states_t5"], "mask": added["text_embedding_mask"],
            "mask_t5": added["text_embedding_mask_t5"]}


@pytest.fixture(scope="module")
def models():
    sd = _random_state(R.build("unet", TINY), 26)
    ref = R.build("unet", TINY, sd)
    port = H.HunyuanDiT2DModel(CFG)
    port.load_state_dict(sd, strict=True)
    return port.eval().requires_grad_(False), ref


def test_the_port_and_the_reference_have_one_layout():
    """The tiny preset is the config the reference reads; at full size the
    port holds diffusers' v1.2 state dict strictly (1544 tensors, 1.500 B
    parameters), the long skips at blocks 21-39."""
    spec = R.DiTSpec.from_config(TINY)
    assert (spec.hidden_size, spec.heads, spec.num_layers, spec.ff_inner, spec.out_channels,
            spec.text_len_t5) == (CFG.hidden_size, CFG.num_attention_heads, CFG.num_layers,
                                  CFG.ff_inner, CFG.out_channels, CFG.text_len_t5)
    published = {k: v for k, v in TINY.items() if k not in ("pool_heads", "time_proj_dim",
                                                              "rope_base")}
    published.update(hidden_size=1408, num_layers=40, num_attention_heads=16, mlp_ratio=4.3637,
                     cross_attention_dim=1024, cross_attention_dim_t5=2048,
                     pooled_projection_dim=1024, text_len_t5=256, sample_size=128)
    ref = R.build("unet", published)
    with torch.device("meta"):
        port = H.HunyuanDiT2DModel(H.HunyuanDiTConfig.hunyuan_dit_v12())
    sd = ref.state_dict()
    port.load_state_dict(sd, strict=True, assign=True)
    assert len(sd) == 1544 and sum(p.numel() for p in port.parameters()) == 1499952032
    assert [n for n, b in enumerate(port.blocks) if b.skip_linear is not None] == list(
        range(21, 40))
    assert tuple(port.blocks[0].ff.net[0].proj.weight.shape) == (6144, 1408)
    assert tuple(port.proj_out.weight.shape) == (32, 1408)


@pytest.mark.parametrize("t", [1, 501, 981])
def test_plain_call_matches_the_reference(models, t):
    port, ref = models
    x, ctx, added = _inputs(3, t)
    got, cache = port(x, t, ctx, added_cond=added)
    want, _ = ref(Precision("fp32"), x, t, ctx, **_ref_kw(added))
    assert cache == {} and got.shape == (3, HW, HW, 4)
    torch.testing.assert_close(got, want, **TOL)


def _edit_calls(port, ref, x3, ctx, added):
    """The pivotal call over K = 2 keyframes (3 streams, frame-major), then
    the propagation call over F_ frames from its cache, on both sides."""
    k = 2
    piv_x, piv_ctx = x3[: 3 * k], ctx[: 3 * k]
    piv_added = {n: v[: 3 * k] for n, v in added.items()}
    got_piv, cache = port(piv_x, 601, piv_ctx, editctx.UNetEdit(
        mode=editctx.EditMode.PIVOTAL, n_frames=k), added_cond=piv_added)
    want_piv, ref_cache = ref(Precision("fp32"), piv_x, 601, piv_ctx,
                              M.Edit("pivotal", k, 3), **_ref_kw(piv_added))
    pa, pb, w1 = (torch.as_tensor(a) for a in propagation_indices(F_, WS))
    got_prop, none = port(x3, 601, ctx, editctx.UNetEdit(
        mode=editctx.EditMode.PROPAGATE, n_frames=F_, cache=cache, prop_pa=pa,
        prop_pb=pb, prop_w1=w1), added_cond=added)
    want_prop, _ = ref(Precision("fp32"), x3, 601, ctx, M.Edit(
        "propagate", F_, 3, cache=ref_cache, pa=pa.long(), pb=pb.long(), w1=w1),
        **_ref_kw(added))
    return (got_piv, want_piv, cache, ref_cache), (got_prop, want_prop, none)


def test_pivotal_and_propagate_calls_match_the_reference(models):
    """40 sites a call at full size, one per block here: the pivotal cache's
    pivot_h (the source stream's AdaLN output) and kf_attn (attn1 after
    to_out, every keyframe's q and k normed and rotated on its own grid
    before the joint keys), and the propagation call gathering from it."""
    port, ref = models
    x3, ctx, added = _inputs(3 * F_, 7)
    visited = editctx.sites_visited
    (gp, wp, cache, ref_cache), (gq, wq, none) = _edit_calls(port, ref, x3, ctx, added)
    assert editctx.sites_visited - visited == 2 * CFG.num_layers
    assert sorted(cache, key=int) == [str(n) for n in range(CFG.num_layers)] == sorted(
        ref_cache, key=int)
    for site in cache:
        for name in ("pivot_h", "kf_attn"):
            torch.testing.assert_close(cache[site][name], ref_cache[site][name], **TOL)
    assert cache["0"]["kf_attn"].shape == (3, 2, (HW // 2) ** 2, CFG.hidden_size)
    torch.testing.assert_close(gp, wp, **TOL)
    assert none == {}
    torch.testing.assert_close(gq, wq, **TOL)


def test_the_extended_attention_rotates_each_keyframe_on_its_own_grid(models, monkeypatch):
    """The joint keys' rotary positions repeat per keyframe: the q handed to
    the shared ``extended_attention`` is each frame's own rotated q, the
    same as a one-frame call's."""
    port, _ = models
    x3, ctx, added = _inputs(6, 9)
    seen = []
    real = H.extended_attention

    def spy(q3, k3, v3, **kw):
        seen.append((q3.clone(), k3.clone()))
        return real(q3, k3, v3, **kw)

    monkeypatch.setattr(H, "extended_attention", spy)
    port(x3, 301, ctx, editctx.UNetEdit(mode=editctx.EditMode.PIVOTAL, n_frames=2),
         added_cond=added)
    q3, _ = seen[0]
    blk = port.blocks[0]
    temb = port.embed(x3, 301, ctx, added)[1]
    tokens = port.embed(x3, 301, ctx, added)[0]
    h = blk.norm1(tokens, temb).reshape(2, 3, -1, CFG.hidden_size).transpose(0, 1)
    rope = port.rope(HW // 2, HW // 2, "cpu")
    for kf in range(2):  # frame kf alone, as a plain call would rotate it
        q, k, _ = blk.attn1.qkv(h[:, kf])
        q, _ = blk.attn1.qk_transform(q, k, rope, rotate_k=True)
        torch.testing.assert_close(q3[:, kf], q.flatten(2), rtol=1e-6, atol=1e-6)


def test_long_skips_pop_in_lifo_order(models, monkeypatch):
    """Block n > L / 2 takes the output of block L - 2 - n: at 6 blocks,
    block 4 block 1's and block 5 block 0's; blocks 0-3 take none."""
    port, _ = models
    outs, skips = {}, {}
    for n, blk in enumerate(port.blocks):
        real = blk.forward

        def spy(x, temb, ctx, rope, edit=None, skip=None, n=n, real=real):
            skips[n] = skip
            y, c = real(x, temb, ctx, rope, edit, skip)
            outs[n] = y
            return y, c

        monkeypatch.setattr(blk, "forward", spy)
    x, ctx, added = _inputs(2, 3)
    port(x, 11, ctx, added_cond=added)
    assert [n for n in range(6) if skips[n] is None] == [0, 1, 2, 3]
    assert skips[4] is outs[1] and skips[5] is outs[0]


def test_the_learned_sigma_half_is_dropped(models, monkeypatch):
    """proj_out writes 2 x 2 x 8 values a token; the model returns the first
    4 channels of each pixel (p, q, c order), the v output."""
    port, _ = models
    x, ctx, added = _inputs(2, 5)
    seen = {}
    real = port.proj_out.forward

    def spy(h):
        seen["out"] = real(h)
        return seen["out"]

    monkeypatch.setattr(port.proj_out, "forward", spy)
    got, _ = port(x, 21, ctx, added_cond=added)
    full = seen["out"].reshape(2, HW // 2, HW // 2, 2, 2, 8)
    # pixel (2i + p, 2j + q), channel c
    for i, j, p, q in ((0, 0, 0, 0), (1, 2, 1, 0), (3, 3, 1, 1), (2, 1, 0, 1)):
        torch.testing.assert_close(got[:, 2 * i + p, 2 * j + q], full[:, i, j, p, q, :4])
    assert not torch.allclose(full[..., 4:], full[..., :4])


def test_rope_against_the_closed_form_and_a_two_by_two_grid():
    """The port's tables against the reference's (diffusers' numpy grid and
    torch frequencies) at the cell's 64 x 64 grid and head dim 88, and
    against the closed form; at a 2 x 2 grid with base 2 by hand: token (i,
    j) at column j and row i, dims 0-3 by the column, 4-7 by the row."""
    cos, sin = H.rope_tables(88, 64, 64, 32, "cpu")
    rc, rs = R.rope(88, 64, 64, 32, "cpu")
    torch.testing.assert_close(cos, rc, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sin, rs, rtol=1e-6, atol=1e-6)
    i, j = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    k = np.arange(22)
    freq = 10000.0 ** (-2 * k / 44)
    ang = np.concatenate([np.repeat(np.outer(j.reshape(-1) / 2, freq), 2, 1),
                          np.repeat(np.outer(i.reshape(-1) / 2, freq), 2, 1)], 1)
    np.testing.assert_allclose(cos.numpy(), np.cos(ang), atol=2e-5)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang), atol=2e-5)
    c2, s2 = H.rope_tables(8, 2, 2, 2, "cpu")
    f = np.array([1.0, 1.0, 0.01, 0.01])  # 10000^(-2k/4), k = 0, 1, each twice
    for tok, (row, col) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        want = np.concatenate([col * f, row * f])
        np.testing.assert_allclose(c2[tok].numpy(), np.cos(want), atol=1e-7)
        np.testing.assert_allclose(s2[tok].numpy(), np.sin(want), atol=1e-7)
    # the rotation of interleaved pairs: (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin)
    x = torch.arange(8.0).reshape(1, 1, 1, 8)
    one = (torch.full((1, 8), 0.6), torch.full((1, 8), 0.8))
    got = H.apply_rope(x, *one)[0, 0, 0]
    pairs = x.reshape(4, 2)
    want = torch.stack([pairs[:, 0] * 0.6 - pairs[:, 1] * 0.8,
                        pairs[:, 1] * 0.6 + pairs[:, 0] * 0.8], 1).reshape(8)
    torch.testing.assert_close(got, want)


def test_the_pool_is_multi_head_attention_forward(models):
    """The pool against torch's ``F.multi_head_attention_forward`` with the
    mean token as the one query (diffusers' HunyuanDiTAttentionPool)."""
    port, ref = models
    pool = port.time_extra_emb.pooler
    x = torch.randn((3, 16, 16), generator=torch.Generator().manual_seed(2))
    got = H.attention_pool(pool, x)
    xl = x.permute(1, 0, 2)
    xl = torch.cat([xl.mean(dim=0, keepdim=True), xl], dim=0)
    xl = xl + pool.positional_embedding[:, None, :]
    want, _ = F.multi_head_attention_forward(
        query=xl[:1], key=xl, value=xl, embed_dim_to_check=16, num_heads=2,
        q_proj_weight=pool.q_proj.weight, k_proj_weight=pool.k_proj.weight,
        v_proj_weight=pool.v_proj.weight, in_proj_weight=None,
        in_proj_bias=torch.cat([pool.q_proj.bias, pool.k_proj.bias, pool.v_proj.bias]),
        bias_k=None, bias_v=None, add_zero_attn=False, dropout_p=0,
        out_proj_weight=pool.c_proj.weight, out_proj_bias=pool.c_proj.bias,
        use_separate_proj_weight=True, training=False, need_weights=False)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(R.pool(Precision("fp32"), ref.time_extra_emb.pooler, x, 2),
                               want[0], rtol=1e-5, atol=1e-5)


def test_text_padding_replaces_the_masked_tokens(models):
    """The context is [CLIP | text_embedder(T5)], every token past a
    prompt's mask taken from ``text_embedding_padding``; the pool sees all
    T5 tokens, masked or not."""
    port, _ = models
    x, ctx, added = _inputs(2, 13)
    _, temb, got = port.embed(x, 5, ctx, added)
    mask = torch.cat([added["text_embedding_mask"], added["text_embedding_mask_t5"]], -1)
    t5_ctx = port.text_embedder(added["encoder_hidden_states_t5"])
    full = torch.cat([ctx, t5_ctx], 1)
    keep = mask.bool()
    assert (~keep).any() and keep.any()
    torch.testing.assert_close(got[keep], full[keep])
    pad = port.text_embedding_padding.expand(2, -1, -1)
    torch.testing.assert_close(got[~keep], pad[~keep])
    # masking T5 tokens moves the context, not the pool (temb)
    masked = dict(added, text_embedding_mask_t5=torch.zeros_like(
        added["text_embedding_mask_t5"]))
    _, temb2, got2 = port.embed(x, 5, ctx, masked)
    torch.testing.assert_close(temb2, temb)
    assert not torch.allclose(got2, got)


def test_the_dit_s_spans(models):
    """``tf.dit`` over a call, ``tf.dit_embed``, ``tf.block:<n>`` a block and
    inside it ``tf.skip`` (blocks 4, 5), ``tf.adaln``, ``tf.rope``,
    ``tf.ext_attn`` / ``tf.propagation`` / ``tf.self_attn``,
    ``tf.cross_attn`` and ``tf.ff``; the outputs bit for bit the same with
    the spans off."""
    from tokenflow_torch import profiling

    port, ref = models
    x3, ctx, added = _inputs(3 * F_, 7)
    off = _edit_calls(port, ref, x3, ctx, added)
    with profiling.spans() as record:
        on = _edit_calls(port, ref, x3, ctx, added)
        port(x3[:2], 5, ctx[:2], added_cond={k: v[:2] for k, v in added.items()})
    assert torch.equal(on[0][0], off[0][0]) and torch.equal(on[1][0], off[1][0])
    names = [s.name for s in record.spans]
    assert names.count("tf.dit") == 3 and names.count("tf.dit_embed") == 3
    assert names.count("tf.block:0") == 3 and names.count("tf.skip") == 3 * 2
    for name, calls in (("tf.ext_attn", 1), ("tf.propagation", 1), ("tf.self_attn", 1)):
        assert names.count(name) == calls * CFG.num_layers, name
    for name in ("tf.adaln", "tf.cross_attn", "tf.ff"):
        assert names.count(name) == 3 * CFG.num_layers, name
    # q/k norm and rotation: attn1 (not in the propagation call) and attn2
    assert names.count("tf.rope") == (2 + 2 + 1) * CFG.num_layers
    parents = {s.name: record.spans[s.parent].name for s in record.spans
               if s.name in ("tf.rope", "tf.skip", "tf.dit_embed")}
    assert parents["tf.skip"] == "tf.block:5" and parents["tf.dit_embed"] == "tf.dit"
    assert parents["tf.rope"] in ("tf.cross_attn", "tf.self_attn", "tf.ext_attn")


def _attention(port, self_attention: bool, dtype):
    blk = port.blocks[0]
    return copy.deepcopy(blk.attn1 if self_attention else blk.attn2).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rotate_k", [True, False], ids=["self", "cross"])
def test_the_cpu_qk_transform_is_unchanged(models, rotate_k, dtype):
    """On the CPU (and for any input K5 does not take) ``qk_transform`` is
    the norms, then ``apply_rope`` on q and, in self attention, on k, bit
    for bit; nothing is counted as a plain rotation on CUDA."""
    port, _ = models
    a = _attention(port, rotate_k, dtype)
    gen = torch.Generator().manual_seed(11)
    q, k = (torch.randn((2, 16, CFG.num_attention_heads, CFG.head_dim), generator=gen)
            .to(dtype) for _ in range(2))
    rope = port.rope(4, 4, "cpu")
    plain_before = H.plain_rope_on_cuda
    got_q, got_k = a.qk_transform(q, k, rope, rotate_k=rotate_k)
    want_q, want_k = H.apply_rope(a.norm_q(q), *rope), a.norm_k(k)
    if rotate_k:
        want_k = H.apply_rope(want_k, *rope)
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    assert H.plain_rope_on_cuda == plain_before


def test_rotated_q_and_k_take_the_rotary_entry(models, monkeypatch):
    """With the norms' path forced to "kernel" (no card here), every rotated
    tensor goes to K5's rotary entry with its own norm's weight, bias and
    eps and the call's tables: q and k in self attention, q alone in cross
    attention, whose k takes ``norm_k`` (``LayerNorm32``, K5 on the card).
    An edit step's two calls make 4 rotary calls a block (160 a step at 40
    blocks): the pivotal pass's self-attention q and k and both passes'
    cross-attention q."""
    port, ref = models
    calls = []

    def rotary(x, w, b, eps, cos, sin):
        calls.append((w, b, eps, x.shape[1], cos.shape[0]))
        return tln.layer_norm_rope_plain(x, w, b, eps, cos, sin)

    monkeypatch.setattr(H, "layer_norm_path", lambda device, dtype: "kernel")
    monkeypatch.setattr(H, "layer_norm_rope_kernel", rotary)
    normed = {"q": 0, "k": 0}  # LayerNorm32 calls of the norm_q / norm_k modules

    def count(which, module, args):
        normed[which] += 1

    hooks = [mod.register_forward_pre_hook(functools.partial(count, name[-1]))
             for name, mod in port.named_modules() if name.endswith((".norm_q", ".norm_k"))]
    try:
        rope = port.rope(4, 4, "cpu")
        q, k = (torch.randn((2, 16, CFG.num_attention_heads, CFG.head_dim)) for _ in range(2))
        for a, rotated in ((port.blocks[0].attn1, ("norm_q", "norm_k")),
                           (port.blocks[0].attn2, ("norm_q",))):
            calls.clear()
            k_before = normed["k"]
            a.qk_transform(q, k, rope, rotate_k=len(rotated) == 2)
            want = [getattr(a, n) for n in rotated]
            assert [(w, b, eps) for w, b, eps, *_ in calls] == [
                (n.weight, n.bias, n.eps) for n in want]
            assert all(s == t == 16 for *_, s, t in calls)
            assert normed["k"] - k_before == (len(rotated) == 1)
        calls.clear()
        normed.update(q=0, k=0)
        x3, ctx, added = _inputs(3 * F_, 7)
        _edit_calls(port, ref, x3, ctx, added)
        assert len(calls) == 4 * CFG.num_layers
        assert normed == {"q": 0, "k": 2 * CFG.num_layers}
    finally:
        for h in hooks:
            h.remove()


def test_pnp_a_controlnet_and_the_fused_step_are_refused(models):
    port, _ = models
    x, ctx, added = _inputs(3, 1)
    with pytest.raises(ValueError, match="PnP is not defined"):
        port(x, 1, ctx, editctx.UNetEdit(pnp=True), added_cond=added)
    with pytest.raises(ValueError, match="no HunyuanDiT ControlNet"):
        port(x, 1, ctx, mid_block_residual=x, added_cond=added)
    with pytest.raises(NotImplementedError, match="fused"):
        port(x, 1, ctx, editctx.UNetEdit(mode=editctx.EditMode.FUSED, n_frames=1,
                                         n_pivots=0), added_cond=added)
    with pytest.raises(ValueError, match="needs added_cond"):
        port(x, 1, ctx)


# ---------------------------------------------------------------------------
# v-prediction in the loop and the inversion
# ---------------------------------------------------------------------------


def _exact(x0: torch.Tensor, level: dict, kind: str):
    """The port's model interface around an output that is the exact eps,
    or v, of the sample against the clean latents ``x0`` at the level
    ``level[t]`` (the benchmark's stub-model case)."""
    def model(sample, t, ctx, edit=None, **kw):
        a = torch.tensor(float(level[int(t)]), dtype=torch.float64)
        s, c = sample.double(), x0.double().expand_as(sample)
        eps = (s - a.sqrt() * c) / (1 - a).sqrt()
        out = eps if kind == "epsilon" else a.sqrt() * eps - (1 - a).sqrt() * c
        return out.float(), {}

    return model


def _ref_of(model):
    def ref(P, sample, t, ctx, edit=None, **kw):
        return model(sample, t, ctx)

    return ref


@pytest.mark.parametrize("kind", ["epsilon", "v_prediction"])
def test_a_v_prediction_edit_step_is_the_reference_s(kind):
    """One SDEdit step (start 0.9 of 10 steps on the DiT's betas) through
    ``tokenflow_sample_loop`` and ``vanilla_sample_loop`` with the exact
    output of ``kind``, against ``reference/steps.py::edit_step``: both land
    on the next level's noised latents; told the other kind, they miss."""
    sched_cfg = dict(SCHEDULER, prediction_type=kind)
    traffic = {"timesteps": 10, "start": 0.9, "save_steps": 10, "guidance_scale": 7.5,
               "editor": "sdedit"}
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((1, HW, HW, 4), generator=gen)
    noise = torch.randn((F_, HW, HW, 4), generator=gen)
    embeds3 = torch.randn((3, 77, 32), generator=gen)
    tables = ref_schedule.edit_tables(sched_cfg, traffic)
    sched = ddim.truncate_schedule(ddim.make_schedule(10, beta_end=0.03), 0.9)
    step = pipeline.split_schedule(pipeline.make_edit_schedule(
        sched, ddim.save_grid(10, 10)[0]), 1)[0]
    assert int(step.timesteps[0]) == int(tables["t"][0])
    a_t, a_prev = float(tables["alpha_t"][0]), float(tables["alpha_prev"][0])
    x = (a_t**0.5 * x0 + (1 - a_t) ** 0.5 * noise).float()
    model = _exact(x0, {int(tables["t"][0]): a_t}, kind)
    traj = x[None].expand(10, -1, -1, -1, -1)
    kw = {} if kind == "epsilon" else {"prediction_type": kind}
    got = pipeline.tokenflow_sample_loop(model, x, traj, embeds3, step, window_size=WS,
                                         guidance_scale=7.5, pnp=False,
                                         pivot_indices=np.array([[0, 2]]), **kw)
    vanilla = pipeline.vanilla_sample_loop(model, x, embeds3[1:], step, guidance_scale=7.5,
                                           **kw)
    pa, pb, w1 = (torch.as_tensor(a) for a in ref_schedule.propagation_indices(F_, WS))
    want = ref_steps.edit_step(Precision("fp32"), _ref_of(model), None, x, x, embeds3,
                               tables, 0, [0, 2], traffic, (frozenset(), None), pa=pa, pb=pb,
                               w1=w1)
    landed = (a_prev**0.5 * x0.double() + (1 - a_prev) ** 0.5 * noise.double()).float()
    for out in (got, vanilla):
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(out, landed, rtol=2e-5, atol=2e-5)
    other = "epsilon" if kind == "v_prediction" else "v_prediction"
    miss = pipeline.vanilla_sample_loop(model, x, embeds3[1:], step, guidance_scale=7.5,
                                        prediction_type=other)
    assert float((miss - landed).abs().max()) > 0.1


@pytest.mark.parametrize("kind", ["epsilon", "v_prediction"])
def test_a_v_prediction_inversion_step_is_the_reference_s(kind):
    """One step of ``ddim_inversion`` with the exact output of ``kind`` at
    the sample's level (alpha_prev) against ``reference/steps.py::
    inversion_step``: both land on the next level."""
    sched_cfg = dict(SCHEDULER, prediction_type=kind)
    traffic = {"timesteps": 10, "save_steps": 10}
    tables = ref_schedule.inversion_tables(sched_cfg, traffic)
    sched = ddim.make_schedule(10, beta_end=0.03)
    gen = torch.Generator().manual_seed(6)
    x0 = torch.randn((1, HW, HW, 4), generator=gen)
    noise = torch.randn((F_, HW, HW, 4), generator=gen)
    i = 3
    a_prev, a_t = float(tables["alpha_prev"][i]), float(tables["alpha_t"][i])
    x = (a_prev**0.5 * x0 + (1 - a_prev) ** 0.5 * noise).float()
    model = _exact(x0, {int(tables["t"][i]): a_prev}, kind)
    kw = {} if kind == "epsilon" else {"prediction_type": kind}
    got, _, _ = inversion.ddim_inversion(lambda s, t: model(s, t, None)[0], x, sched, 10,
                                         steps=slice(i, i + 1), **kw)
    want = ref_steps.inversion_step(Precision("fp32"), _ref_of(model), None, x,
                                    torch.zeros((1, 77, 32)), tables, i)
    landed = (a_t**0.5 * x0.double() + (1 - a_t) ** 0.5 * noise.double()).float()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, landed, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("loop", ["tokenflow", "vanilla"])
def test_the_v_state_is_held_in_fp32_between_steps(loop):
    """Under v both loops hold x in fp32 and hand every model call a copy
    in the embeddings' dtype (bf16 here), and return it in fp32, so two
    calls of one step each are one call of two steps bit for bit; under
    eps the model sees x_init's dtype and the loop returns it."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((F_, HW, HW, 4), generator=gen).bfloat16()
    embeds3 = torch.randn((3, 77, 32), generator=gen).bfloat16()
    sched = ddim.truncate_schedule(ddim.make_schedule(10, beta_end=0.03), 0.9)
    edit = pipeline.make_edit_schedule(sched, ddim.save_grid(10, 10)[0])
    one, two = pipeline.split_schedule(edit, 1), pipeline.split_schedule(edit, 2)[0]
    seen = []

    def model(sample, t, ctx, edit=None, **kw):
        seen.append(sample.dtype)
        return 0.5 * sample.float() - 0.01 * t, {}

    def run(x_in, steps, kind):
        if loop == "vanilla":
            return pipeline.vanilla_sample_loop(model, x_in, embeds3[1:], steps,
                                                guidance_scale=7.5, prediction_type=kind)
        n = len(steps.timesteps)
        return pipeline.tokenflow_sample_loop(
            model, x_in, x[None].expand(10, -1, -1, -1, -1), embeds3, steps, window_size=WS,
            guidance_scale=7.5, pnp=False, pivot_indices=np.array([[0, 2]] * n),
            prediction_type=kind)

    whole = run(x, two, "v_prediction")
    split = run(run(x, one[0], "v_prediction"), one[1], "v_prediction")
    assert whole.dtype == torch.float32 and torch.equal(whole, split)
    assert set(seen) == {torch.bfloat16}
    seen.clear()
    assert run(x, one[0], "epsilon").dtype == torch.bfloat16 and set(seen) == {torch.bfloat16}


def test_the_eps_updates_are_unchanged_bit_for_bit():
    """``ddim_step`` and ``ddim_invert_step`` on eps, with and without the
    keyword, compute what the eps formulas computed before, operation for
    operation; another prediction type raises."""
    gen = torch.Generator().manual_seed(4)
    x, eps = torch.randn((2, 4, 4, 4), generator=gen).bfloat16(), torch.randn(
        (2, 4, 4, 4), generator=gen)
    a_t, a_prev = np.float32(0.3), np.float32(0.6)
    a, ap = torch.tensor(0.3), torch.tensor(0.6)
    xf = x.float()
    x0 = (xf - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
    want = torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * eps
    for got in (ddim.ddim_step(x, eps, a_t, a_prev),
                ddim.ddim_step(x, eps, a_t, a_prev, "epsilon")):
        assert torch.equal(got, want)
    x0 = (xf - torch.sqrt(1.0 - ap) * eps) / torch.sqrt(ap)
    want = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    for got in (ddim.ddim_invert_step(x, eps, a_t, a_prev),
                ddim.ddim_invert_step(x, eps, a_t, a_prev, "epsilon")):
        assert torch.equal(got, want)
    for fn in (ddim.ddim_step, ddim.ddim_invert_step):
        with pytest.raises(ValueError, match="prediction_type 'sample'"):
            fn(x, eps, a_t, a_prev, "sample")
    with pytest.raises(ValueError, match="prediction_type"):
        pipeline.vanilla_sample_loop(None, x, eps, None, guidance_scale=1.0,
                                     prediction_type="sample")


@pytest.mark.parametrize("offset", [0, 1])
def test_the_save_grid_follows_the_steps_offset(offset):
    """At either offset the edit's timesteps lie on the save grid, which is
    the reference's (``reference/schedule.py::save_grid``), and the
    inversion saves onto it."""
    cfg = dict(SCHEDULER, steps_offset=offset)
    save = ddim.save_grid(100, 50, steps_offset=offset)
    assert np.array_equal(save[0], ref_schedule.save_grid(cfg, 50))
    assert save[1].sum() == 50
    sched = ddim.truncate_schedule(ddim.make_schedule(50, beta_end=0.03, steps_offset=offset),
                                   0.9)
    pipeline.make_edit_schedule(sched, save[0])  # no timestep off the grid
    assert int(save[0][0]) == offset
    inv = ddim.make_schedule(100, beta_end=0.03, steps_offset=offset)
    tables, save_ts = inversion.inversion_xs(inv, 50)
    assert np.array_equal(save_ts, save[0]) and tables[3].sum() == 50
    if offset != 1:  # SD's default grid misses every timestep of this offset
        with pytest.raises(ValueError, match="not on the inversion save grid"):
            pipeline.make_edit_schedule(sched, ddim.save_grid(100, 50)[0])


# ---------------------------------------------------------------------------
# the kernel plans the DiT adds, the existing ones unchanged
# ---------------------------------------------------------------------------

CSRC = REPO / "tokenflow_torch" / "csrc"


def test_k1_and_k6_take_head_dim_88_with_the_plans_before_unchanged():
    """K1's bf16 launcher sends D = 88 to D = 80's plan (two consumers), the
    others where they went; fp32 keeps SD's four; K6 dispatches 88 as the
    others; the wgmma helper at N = 88 is m64n88k16 with 44 accumulators."""
    assert tfa.HEAD_DIMS == tsa.HEAD_DIMS == (40, 64, 80, 88, 160)
    assert tfa.HEAD_DIMS_F32 == (40, 64, 80, 160)
    src = (CSRC / "flash_attention.cu").read_text()
    launcher = re.search(r'extern "C" int tf_flash_attention\((.*?)\n\}', src, re.S).group(1)
    plans = dict(re.findall(r"case (\d+): return launch<\d+, (\d)>", launcher))
    assert plans == {"40": "3", "64": "3", "80": "2", "88": "2"}
    assert "launch<160, 2>" in launcher and "launch<160, 3>" in launcher
    plan_fn = re.search(r'extern "C" int tf_flash_attention_plan\((.*?)\n\}', src,
                        re.S).group(1)
    assert dict(re.findall(r"case (\d+): return write_plan<\d+, (\d)>", plan_fn)) == plans
    short = (CSRC / "short_attention.cu").read_text()
    assert "case 88: return dispatch<88>(TF_SHORT_ARGS);" in short
    hopper = (CSRC / "hopper.cuh").read_text()
    helper = re.search(r"void wgmma_m64n88k16_rs\(float \(&d\)\[44\].*?\n\}", hopper, re.S)
    assert helper and "m64n88k16.f32.bf16.bf16" in helper.group(0)
    assert len(re.findall(r'"\+f"\(d\[\d+\]\)', helper.group(0))) == 44
    assert "if constexpr (N == 88) wgmma_m64n88k16_rs(d, a, db);" in hopper


@pytest.mark.parametrize("d,dtype", [(88, torch.float32), (96, torch.bfloat16),
                                     (88, torch.float16)])
def test_k1_refuses_head_dim_88_outside_bf16(d, dtype):
    q = torch.zeros(1, 8, 1, d, dtype=dtype)
    with pytest.raises(NotImplementedError, match="head dim"):
        tfa.flash_attention_kernel(q, q, q)


def test_the_match_core_takes_1408_with_three_stages():
    """csrc/token_match_core.cuh: 1280 < D <= 1408 takes one consumer and
    three 16 KB stages beside the 180,224-byte query tile (four do not fit
    in the 232,448 bytes); the narrower widths keep their consumers and
    rings; the wrapper refuses past 1408 (bf16) and past 1280 (fp32)."""
    src = (CSRC / "token_match_core.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (kCore\w+) = (\d+);", src)}
    assert (const["kCoreMaxD"], const["kCoreFourStageMaxD"], const["kCoreWideStages"]) == (
        1408, 1280, 3)
    assert ttm.MAX_D == const["kCoreMaxD"] and ttm.MAX_D_F32 == 1280
    assert "return d <= 320 ? 3 : d <= 640 ? 2 : 1;" in src
    stages = dict(re.findall(r"struct CoreShape<(\d)> \{\s*static constexpr int kStages = (\d+)",
                             src))
    assert stages == {"3": "6", "2": "4", "1": "4"}
    launcher = re.search(r"inline int launch_match_core\((.*?)\n\}", src, re.S).group(1)
    assert re.search(r"if \(d > kCoreFourStageMaxD\)\s*return launch_core<1, kCoreWideStages>",
                     launcher)

    def smem(d, stages):  # core_smem_bytes<1, stages>(d / 64)
        return d // 64 * 64 * 128 + stages * 16384 + 8 * (1 + 2 * stages) + 1024

    assert smem(1408, 3) <= 232448 < smem(1408, 4) and smem(1280, 4) <= 232448

    def operands(d, dtype):
        f, k, s = 2, 3, 16
        return (torch.zeros(f, s, d, dtype=dtype), torch.zeros(k, s, d, dtype=dtype),
                torch.zeros(3, k, s, d, dtype=dtype), torch.zeros(f, dtype=torch.int32),
                torch.ones(f, dtype=torch.int32), torch.full((f,), 0.5))

    ttm.check_operands("K2", *operands(1408, torch.bfloat16))
    for d, dtype in ((1416, torch.bfloat16), (1408, torch.float32)):
        with pytest.raises(NotImplementedError, match="D <="):
            ttm.check_operands("K2", *operands(d, dtype))


def test_layer_norm_plans_at_the_dit_widths():
    """K5: the per-head QK norm at 88 takes 4 lanes x 3 vectors, the blocks'
    1408 32 x 6, the long skips' 2816 32 x 11 (instantiated at 32 lanes
    only); the UNets' and CLIP's widths keep their plans."""
    assert tuple(tln.plan(88)) == (4, 3) and tuple(tln.plan(1408)) == (32, 6)
    assert tuple(tln.plan(2816)) == (32, 11) and tln.MAX_CHANNELS == 2816
    assert {c: tuple(tln.plan(c)) for c in (320, 640, 1280, 768, 1024)} == {
        320: (8, 5), 640: (16, 5), 1280: (32, 5), 768: (32, 3), 1024: (32, 4)}
    src = (CSRC / "layer_norm.cu").read_text()
    wide = re.search(r"Kernel kernel_for_wide\(int vecs\) \{(.*?)\n\}", src, re.S).group(1)
    assert re.findall(r"case (\d+): return layer_norm_kernel<32, \d+>", wide) == [
        "9", "10", "11"]
    with pytest.raises(NotImplementedError):
        tln.plan(2824)


@pytest.mark.cuda
def test_k1_and_k6_at_head_dim_88_on_cuda():
    """K1 (2 x 1500 rows against 2100 keys) and K6 (333 keys) at D = 88
    against sdp_attention on fp32 copies, within K1's limits (skips without
    a GPU; chip_smoke.py's DiT rows cover the cell's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from tokenflow_torch.ops.attention import sdp_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, (b, sq, skv) in ((tfa.flash_attention_kernel, (2, 1500, 2100)),
                                 (tsa.short_attention_kernel, (3, 1000, 333))):
        q, k, v = (torch.randn((b, s, 16, 88), generator=gen, device="cuda").bfloat16()
                   for s in (sq, skv, skv))
        got = kernel(q, k, v)
        ref = sdp_attention(q.float(), k.float(), v.float())
        err = (got.float() - ref).norm() / ref.norm()
        assert float(err) < 5e-3 and float((got.float() - ref).abs().max()) < 2e-2

"""Value-level torch goldens for every weight-converter rule.

Round-1 gap (VERDICT.md "What's weak" #2): the converter was tested for key
routing and shapes only; a silent layout bug (head interleave, GEGLU split
order, flip_sin_to_cos, conv-vs-linear projections, up/downsample padding)
would produce garbage with real checkpoints. diffusers is not installed
here, so each test hand-writes a torch-functional mirror of the published
diffusers module semantics (float64), builds a state dict under the REAL
diffusers key names, pushes it through ``convert_*_state_dict``, and
asserts allclose against the Flax module — covering both the numerics and
the key-rewrite rules at once.

Reference contract: the checkpoints the reference loads at
preprocess.py:51-57 / run_tokenflow_pnp.py:47-53 (SD UNet / VAE / CLIP).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from tokenflow_tpu.models import weights as W  # noqa: E402
from tokenflow_tpu.models.layers import (  # noqa: E402
    Attention,
    BasicTransformerBlock,
    Downsample2D,
    GEGLUFeedForward,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    timestep_embedding,
)
from tokenflow_tpu.models.unet2d import (  # noqa: E402
    UNet2DConfig,
    UNet2DConditionModel,
)
from tokenflow_tpu.models.vae import (  # noqa: E402
    AutoencoderKL,
    AutoencoderKLConfig,
)


# ---------------------------------------------------------------------------
# state-dict builders (diffusers key names, float64 values)
# ---------------------------------------------------------------------------


class _SD(dict):
    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def _t(self, *shape, scale=1.0):
        return torch.tensor(
            self.rng.standard_normal(shape) * scale, dtype=torch.float64
        )

    def conv(self, p, cin, cout, k=3):
        self[f"{p}.weight"] = self._t(
            cout, cin, k, k, scale=1.0 / math.sqrt(cin * k * k)
        )
        self[f"{p}.bias"] = self._t(cout, scale=0.05)

    def lin(self, p, cin, cout, bias=True):
        self[f"{p}.weight"] = self._t(cout, cin, scale=1.0 / math.sqrt(cin))
        if bias:
            self[f"{p}.bias"] = self._t(cout, scale=0.05)

    def norm(self, p, c):
        self[f"{p}.weight"] = 1.0 + self._t(c, scale=0.1)
        self[f"{p}.bias"] = self._t(c, scale=0.1)

    def resnet(self, p, cin, cout, temb_dim=None):
        self.norm(f"{p}.norm1", cin)
        self.conv(f"{p}.conv1", cin, cout)
        if temb_dim is not None:
            self.lin(f"{p}.time_emb_proj", temb_dim, cout)
        self.norm(f"{p}.norm2", cout)
        self.conv(f"{p}.conv2", cout, cout)
        if cin != cout:
            self.conv(f"{p}.conv_shortcut", cin, cout, k=1)

    def attn(self, p, q_dim, kv_dim, inner):
        self.lin(f"{p}.to_q", q_dim, inner, bias=False)
        self.lin(f"{p}.to_k", kv_dim, inner, bias=False)
        self.lin(f"{p}.to_v", kv_dim, inner, bias=False)
        self.lin(f"{p}.to_out.0", inner, q_dim)

    def tblock(self, p, dim, ctx_dim):
        self.norm(f"{p}.norm1", dim)
        self.attn(f"{p}.attn1", dim, dim, dim)
        self.norm(f"{p}.norm2", dim)
        self.attn(f"{p}.attn2", dim, ctx_dim, dim)
        self.norm(f"{p}.norm3", dim)
        self.lin(f"{p}.ff.net.0.proj", dim, 8 * dim)
        self.lin(f"{p}.ff.net.2", 4 * dim, dim)

    def t2d(self, p, c, ctx_dim, linear):
        self.norm(f"{p}.norm", c)
        if linear:
            self.lin(f"{p}.proj_in", c, c)
            self.lin(f"{p}.proj_out", c, c)
        else:
            self.conv(f"{p}.proj_in", c, c, k=1)
            self.conv(f"{p}.proj_out", c, c, k=1)
        self.tblock(f"{p}.transformer_blocks.0", c, ctx_dim)

    def vae_attn(self, p, c):
        self.norm(f"{p}.group_norm", c)
        self.lin(f"{p}.to_q", c, c)
        self.lin(f"{p}.to_k", c, c)
        self.lin(f"{p}.to_v", c, c)
        self.lin(f"{p}.to_out.0", c, c)


# ---------------------------------------------------------------------------
# torch functional mirrors of diffusers module semantics
# ---------------------------------------------------------------------------


def _gn(x, sd, p, groups, eps):
    return F.group_norm(x, groups, sd[f"{p}.weight"], sd[f"{p}.bias"], eps)


def _conv(x, sd, p, stride=1, padding=1):
    return F.conv2d(
        x, sd[f"{p}.weight"], sd[f"{p}.bias"], stride=stride, padding=padding
    )


def _lin(x, sd, p):
    return F.linear(x, sd[f"{p}.weight"], sd.get(f"{p}.bias"))


def _ln(x, sd, p):
    return F.layer_norm(
        x, (x.shape[-1],), sd[f"{p}.weight"], sd[f"{p}.bias"], 1e-5
    )


def torch_timestep_embedding(
    t, dim, flip_sin_to_cos=True, freq_shift=0.0, max_period=10000.0
):
    # diffusers get_timestep_embedding semantics
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float64
    )
    emb = torch.exp(exponent / (half - freq_shift))
    emb = t.double()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def torch_resnet(x, temb, sd, p, groups=32, eps=1e-5):
    h = F.silu(_gn(x, sd, f"{p}.norm1", groups, eps))
    h = _conv(h, sd, f"{p}.conv1")
    if temb is not None and f"{p}.time_emb_proj.weight" in sd:
        h = h + _lin(F.silu(temb), sd, f"{p}.time_emb_proj")[:, :, None, None]
    h = F.silu(_gn(h, sd, f"{p}.norm2", groups, eps))
    h = _conv(h, sd, f"{p}.conv2")
    if f"{p}.conv_shortcut.weight" in sd:
        x = _conv(x, sd, f"{p}.conv_shortcut", padding=0)
    return x + h


def torch_attention(x, ctx, sd, p, heads):
    # diffusers Attention: head h = contiguous slice [h*d:(h+1)*d] of inner
    ctx = x if ctx is None else ctx
    q = _lin(x, sd, f"{p}.to_q")
    k = _lin(ctx, sd, f"{p}.to_k")
    v = _lin(ctx, sd, f"{p}.to_v")
    b, s, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, -1, heads, d).permute(0, 2, 1, 3)

    q, k, v = split(q), split(k), split(v)
    probs = torch.softmax(q @ k.transpose(-1, -2) * d**-0.5, dim=-1)
    o = (probs @ v).permute(0, 2, 1, 3).reshape(b, s, inner)
    return _lin(o, sd, f"{p}.to_out.0")


def torch_geglu_ff(x, sd, p):
    h = _lin(x, sd, f"{p}.ff.net.0.proj")
    h, gate = h.chunk(2, dim=-1)
    return _lin(h * F.gelu(gate), sd, f"{p}.ff.net.2")


def torch_tblock(x, ctx, sd, p, heads):
    x = x + torch_attention(_ln(x, sd, f"{p}.norm1"), None, sd, f"{p}.attn1", heads)
    x = x + torch_attention(_ln(x, sd, f"{p}.norm2"), ctx, sd, f"{p}.attn2", heads)
    x = x + torch_geglu_ff(_ln(x, sd, f"{p}.norm3"), sd, p)
    return x


def torch_t2d(x, ctx, sd, p, heads, linear):
    b, c, hh, ww = x.shape
    res = x
    h = _gn(x, sd, f"{p}.norm", 32, 1e-6)
    if linear:
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = _lin(h, sd, f"{p}.proj_in")
    else:
        h = _conv(h, sd, f"{p}.proj_in", padding=0)
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
    h = torch_tblock(h, ctx, sd, f"{p}.transformer_blocks.0", heads)
    if linear:
        h = _lin(h, sd, f"{p}.proj_out")
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    else:
        h = h.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
        h = _conv(h, sd, f"{p}.proj_out", padding=0)
    return h + res


def torch_vae_attn(x, sd, p, groups, eps):
    b, c, hh, ww = x.shape
    h = _gn(x, sd, f"{p}.group_norm", groups, eps)
    h = h.reshape(b, c, hh * ww).transpose(1, 2)
    q = _lin(h, sd, f"{p}.to_q")
    k = _lin(h, sd, f"{p}.to_k")
    v = _lin(h, sd, f"{p}.to_v")
    probs = torch.softmax(q @ k.transpose(-1, -2) * c**-0.5, dim=-1)
    o = _lin(probs @ v, sd, f"{p}.to_out.0")
    return x + o.transpose(1, 2).reshape(b, c, hh, ww)


# ---------------------------------------------------------------------------
# converter plumbing helpers
# ---------------------------------------------------------------------------


def _to_np(sd):
    return {k: v.numpy().astype(np.float32) for k, v in sd.items()}


def _nhwc(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1), jnp.float32)


def _nchw_ref(t):
    return t.numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# unit goldens, one per converter rule family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_timestep_embedding_matches_torch(flip, shift):
    t = torch.tensor([0, 1, 7, 501, 999])
    ref = torch_timestep_embedding(
        t, 32, flip_sin_to_cos=flip, freq_shift=shift
    ).numpy()
    out = timestep_embedding(
        jnp.asarray(t.numpy()), 32, flip_sin_to_cos=flip, freq_shift=shift
    )
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_time_embedding_mlp_matches_torch():
    sd = _SD(0)
    sd.lin("time_embedding.linear_1", 16, 64)
    sd.lin("time_embedding.linear_2", 64, 64)
    x = sd._t(3, 16)
    ref = _lin(
        F.silu(_lin(x, sd, "time_embedding.linear_1")),
        sd,
        "time_embedding.linear_2",
    ).numpy()

    params = W.convert_unet_state_dict(_to_np(sd))["time_embedding"]
    out = TimestepEmbedding(embed_dim=64).apply(
        {"params": params}, jnp.asarray(x.numpy(), jnp.float32)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_attention_head_layout_matches_torch():
    """Multi-head (4x distinct heads), q_dim != kv_dim (cross-attn shape):
    catches any head interleave/transpose error in split/merge + converter."""
    dim, ctx_dim, heads = 32, 24, 4
    sd = _SD(1)
    sd.attn("down_blocks.0.attentions.0.transformer_blocks.0.attn2",
            dim, ctx_dim, dim)
    x = sd._t(2, 9, dim)
    ctx = sd._t(2, 5, ctx_dim)
    p = "down_blocks.0.attentions.0.transformer_blocks.0.attn2"
    ref = torch_attention(x, ctx, sd, p, heads).numpy()

    params = W.convert_unet_state_dict(_to_np(sd))
    attn_params = params["down_0_attn_0"]["block"]["attn2"]
    model = Attention(heads=heads, dim_head=dim // heads, out_dim=dim)
    out = model.apply(
        {"params": attn_params},
        jnp.asarray(x.numpy(), jnp.float32),
        jnp.asarray(ctx.numpy(), jnp.float32),
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_geglu_ff_matches_torch():
    """GEGLU split order: diffusers ff.net.0.proj outputs [hidden | gate];
    a swapped split would silently flip value/gate roles."""
    dim = 16
    sd = _SD(2)
    p = "down_blocks.0.attentions.0.transformer_blocks.0"
    sd.lin(f"{p}.ff.net.0.proj", dim, 8 * dim)
    sd.lin(f"{p}.ff.net.2", 4 * dim, dim)
    x = sd._t(2, 6, dim)
    ref = torch_geglu_ff(x, sd, p).numpy()

    params = W.convert_unet_state_dict(_to_np(sd))
    ff_params = params["down_0_attn_0"]["block"]["ff"]
    out = GEGLUFeedForward(dim=dim).apply(
        {"params": ff_params}, jnp.asarray(x.numpy(), jnp.float32)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # sanity: the mirror itself is order-sensitive
    swapped = dict(sd)
    w = sd[f"{p}.ff.net.0.proj.weight"]
    b = sd[f"{p}.ff.net.0.proj.bias"]
    swapped[f"{p}.ff.net.0.proj.weight"] = torch.cat(
        [w[4 * dim:], w[:4 * dim]], dim=0
    )
    swapped[f"{p}.ff.net.0.proj.bias"] = torch.cat(
        [b[4 * dim:], b[:4 * dim]], dim=0
    )
    assert not np.allclose(torch_geglu_ff(x, swapped, p).numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_geglu_ff_matches_jax(dtype):
    """The port's GEGLUFeedForward on the CPU, the plain version that K7
    replaces on a bf16 CUDA stack only: in fp32 it equals the JAX
    GEGLUFeedForward on the same diffusers weights; in bf16 it equals its
    own projection, split and exact GELU, bit for bit."""
    from tokenflow_torch.kernels.geglu import geglu_plain
    from tokenflow_torch.models.layers import GEGLUFeedForward as PortFF

    dim = 16
    sd = _SD(2)
    p = "down_blocks.0.attentions.0.transformer_blocks.0"
    sd.lin(f"{p}.ff.net.0.proj", dim, 8 * dim)
    sd.lin(f"{p}.ff.net.2", 4 * dim, dim)
    x = sd._t(2, 6, dim)
    params = W.convert_unet_state_dict(_to_np(sd))["down_0_attn_0"]["block"]["ff"]
    ref = np.asarray(GEGLUFeedForward(dim=dim).apply(
        {"params": params}, jnp.asarray(x.numpy(), jnp.float32)))
    port = PortFF(dim).to(dtype)
    port.load_state_dict({k[len(p) + 4:]: v.to(dtype) for k, v in sd.items()
                          if k.startswith(f"{p}.ff.")})
    with torch.no_grad():
        out = port(x.to(dtype))
        if dtype == torch.float32:
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
        else:
            proj = port.net[0].proj
            h = geglu_plain(x.to(dtype), proj.weight, proj.bias)
            assert torch.equal(out, port.net[2](h))


def test_basic_transformer_block_matches_torch():
    dim, ctx_dim, heads = 32, 24, 2
    sd = _SD(3)
    p = "mid_block.attentions.0.transformer_blocks.0"
    sd.tblock(p, dim, ctx_dim)
    x = sd._t(2, 9, dim)
    ctx = sd._t(2, 5, ctx_dim)
    ref = torch_tblock(x, ctx, sd, p, heads).numpy()

    params = W.convert_unet_state_dict(_to_np(sd))["mid_attn"]["block"]
    model = BasicTransformerBlock(dim=dim, heads=heads, dim_head=dim // heads)
    out, cache = model.apply(
        {"params": params},
        jnp.asarray(x.numpy(), jnp.float32),
        jnp.asarray(ctx.numpy(), jnp.float32),
    )
    assert cache is None
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("linear", [True, False])
def test_transformer2d_matches_torch(linear):
    """Both projection generations: Linear (SD-2.x) and 1x1-conv (SD-1.5)."""
    c, ctx_dim, heads = 64, 24, 2
    sd = _SD(4)
    p = "up_blocks.1.attentions.2"
    sd.t2d(p, c, ctx_dim, linear)
    x = sd._t(2, c, 6, 6)
    ctx = sd._t(2, 5, ctx_dim)
    ref = _nchw_ref(torch_t2d(x, ctx, sd, p, heads, linear))

    params = W.convert_unet_state_dict(_to_np(sd))["up_1_attn_2"]
    model = Transformer2DModel(
        channels=c, heads=heads, dim_head=c // heads,
        use_linear_projection=linear,
    )
    out, _ = model.apply(
        {"params": params},
        _nhwc(x),
        jnp.asarray(ctx.numpy(), jnp.float32),
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_downsample_matches_torch_unet_and_vae():
    c = 16
    sd = _SD(5)
    sd.conv("down_blocks.0.downsamplers.0.conv", c, c)
    x = sd._t(2, c, 10, 10)
    p = "down_blocks.0.downsamplers.0.conv"
    params = W.convert_unet_state_dict(_to_np(sd))["down_0_downsample"]

    # UNet: symmetric padding-1 stride-2
    ref = _nchw_ref(_conv(x, sd, p, stride=2, padding=1))
    out = Downsample2D(channels=c).apply({"params": params}, _nhwc(x))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    # VAE encoder: F.pad (0,1,0,1) then stride-2 valid conv
    ref_vae = _nchw_ref(
        _conv(F.pad(x, (0, 1, 0, 1)), sd, p, stride=2, padding=0)
    )
    out_vae = Downsample2D(channels=c, asymmetric_pad=True).apply(
        {"params": params}, _nhwc(x)
    )
    np.testing.assert_allclose(out_vae, ref_vae, rtol=1e-4, atol=1e-5)


def test_upsample_matches_torch():
    c = 16
    sd = _SD(6)
    sd.conv("up_blocks.0.upsamplers.0.conv", c, c)
    x = sd._t(2, c, 5, 5)
    up = F.interpolate(x, scale_factor=2.0, mode="nearest")
    ref = _nchw_ref(_conv(up, sd, "up_blocks.0.upsamplers.0.conv"))

    params = W.convert_unet_state_dict(_to_np(sd))["up_0_upsample"]
    out = Upsample2D(channels=c).apply({"params": params}, _nhwc(x))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_vae_mid_attention_matches_torch():
    c, groups, eps = 32, 8, 1e-6
    sd = _SD(7)
    sd.vae_attn("encoder.mid_block.attentions.0", c)
    x = sd._t(2, c, 6, 6)
    ref = _nchw_ref(
        torch_vae_attn(x, sd, "encoder.mid_block.attentions.0", groups, eps)
    )

    from tokenflow_tpu.models.vae import VAEAttention

    params = W.convert_vae_state_dict(_to_np(sd))["encoder"]["mid_attn"]
    out = VAEAttention(channels=c, groups=groups, eps=eps).apply(
        {"params": params}, _nhwc(x)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# full-model goldens (tiny configs): numerics + complete key coverage
# ---------------------------------------------------------------------------


def _build_vae_sd(cfg):
    sd = _SD(8)
    chans = list(cfg.block_out_channels)
    n = len(chans)
    # encoder
    sd.conv("encoder.conv_in", cfg.in_channels, chans[0])
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            sd.resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, ch)
            cin = ch
        if i < n - 1:
            sd.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    sd.resnet("encoder.mid_block.resnets.0", chans[-1], chans[-1])
    sd.vae_attn("encoder.mid_block.attentions.0", chans[-1])
    sd.resnet("encoder.mid_block.resnets.1", chans[-1], chans[-1])
    sd.norm("encoder.conv_norm_out", chans[-1])
    sd.conv("encoder.conv_out", chans[-1], 2 * cfg.latent_channels)
    sd.conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
    # decoder
    rev = chans[::-1]
    sd.conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, 1)
    sd.conv("decoder.conv_in", cfg.latent_channels, rev[0])
    sd.resnet("decoder.mid_block.resnets.0", rev[0], rev[0])
    sd.vae_attn("decoder.mid_block.attentions.0", rev[0])
    sd.resnet("decoder.mid_block.resnets.1", rev[0], rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            sd.resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, ch)
            cin = ch
        if i < n - 1:
            sd.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    sd.norm("decoder.conv_norm_out", rev[-1])
    sd.conv("decoder.conv_out", rev[-1], cfg.out_channels)
    return sd


def torch_vae_encode_moments(x, sd, cfg):
    g, eps = cfg.norm_groups, cfg.norm_eps
    chans = list(cfg.block_out_channels)
    n = len(chans)
    h = _conv(x, sd, "encoder.conv_in")
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            h = torch_resnet(
                h, None, sd, f"encoder.down_blocks.{i}.resnets.{j}", g, eps
            )
        if i < n - 1:
            h = _conv(
                F.pad(h, (0, 1, 0, 1)), sd,
                f"encoder.down_blocks.{i}.downsamplers.0.conv",
                stride=2, padding=0,
            )
    h = torch_resnet(h, None, sd, "encoder.mid_block.resnets.0", g, eps)
    h = torch_vae_attn(h, sd, "encoder.mid_block.attentions.0", g, eps)
    h = torch_resnet(h, None, sd, "encoder.mid_block.resnets.1", g, eps)
    h = F.silu(_gn(h, sd, "encoder.conv_norm_out", g, eps))
    h = _conv(h, sd, "encoder.conv_out")
    return _conv(h, sd, "quant_conv", padding=0)


def torch_vae_decode(z, sd, cfg):
    g, eps = cfg.norm_groups, cfg.norm_eps
    rev = list(cfg.block_out_channels)[::-1]
    n = len(rev)
    h = _conv(z, sd, "post_quant_conv", padding=0)
    h = _conv(h, sd, "decoder.conv_in")
    h = torch_resnet(h, None, sd, "decoder.mid_block.resnets.0", g, eps)
    h = torch_vae_attn(h, sd, "decoder.mid_block.attentions.0", g, eps)
    h = torch_resnet(h, None, sd, "decoder.mid_block.resnets.1", g, eps)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            h = torch_resnet(
                h, None, sd, f"decoder.up_blocks.{i}.resnets.{j}", g, eps
            )
        if i < n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(h, sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    h = F.silu(_gn(h, sd, "decoder.conv_norm_out", g, eps))
    return _conv(h, sd, "decoder.conv_out")


def test_full_vae_matches_torch():
    """Complete tiny VAE through the converter: encoder (incl. asymmetric
    downsample + mid attention), quant convs, decoder — value-level."""
    cfg = AutoencoderKLConfig.tiny()
    sd = _build_vae_sd(cfg)
    model = AutoencoderKL(cfg)

    x = sd._t(2, cfg.in_channels, 16, 16)
    z = sd._t(2, cfg.latent_channels, 4, 4)
    ref_moments = torch_vae_encode_moments(x, sd, cfg)
    ref_mean = _nchw_ref(ref_moments[:, : cfg.latent_channels])
    ref_dec = _nchw_ref(torch_vae_decode(z, sd, cfg))

    params = W.convert_vae_state_dict(_to_np(sd))
    expected = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, 16, 16, cfg.in_channels), jnp.float32),
        )
    )
    W.assert_params_match(params, expected["params"])

    mean, _ = model.apply(
        {"params": params}, _nhwc(x), method=model.encode_moments
    )
    np.testing.assert_allclose(mean, ref_mean, rtol=2e-3, atol=2e-4)
    dec = model.apply({"params": params}, _nhwc(z), method=model.decode)
    np.testing.assert_allclose(dec, ref_dec, rtol=2e-3, atol=2e-4)


def _build_unet_sd(cfg, seed=9):
    sd = _SD(seed)
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb_dim = chans[0] * 4
    sd.conv("conv_in", cfg.in_channels, chans[0])
    sd.lin("time_embedding.linear_1", chans[0], temb_dim)
    sd.lin("time_embedding.linear_2", temb_dim, temb_dim)
    cin = chans[0]
    skips = [chans[0]]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            sd.resnet(f"down_blocks.{i}.resnets.{j}", cin, ch, temb_dim)
            cin = ch
            if cfg.attn_down[i]:
                sd.t2d(
                    f"down_blocks.{i}.attentions.{j}", ch,
                    cfg.cross_attention_dim, cfg.use_linear_projection,
                )
            skips.append(ch)
        if i < n - 1:
            sd.conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
            skips.append(ch)
    sd.resnet("mid_block.resnets.0", chans[-1], chans[-1], temb_dim)
    sd.t2d(
        "mid_block.attentions.0", chans[-1], cfg.cross_attention_dim,
        cfg.use_linear_projection,
    )
    sd.resnet("mid_block.resnets.1", chans[-1], chans[-1], temb_dim)
    rev = chans[::-1]
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            sd.resnet(
                f"up_blocks.{i}.resnets.{j}", cin + skips.pop(), rev[i],
                temb_dim,
            )
            cin = rev[i]
            if cfg.attn_up[i]:
                sd.t2d(
                    f"up_blocks.{i}.attentions.{j}", rev[i],
                    cfg.cross_attention_dim, cfg.use_linear_projection,
                )
        if i < n - 1:
            sd.conv(f"up_blocks.{i}.upsamplers.0.conv", rev[i], rev[i])
    sd.norm("conv_norm_out", chans[0])
    sd.conv("conv_out", chans[0], cfg.out_channels)
    return sd


def torch_unet(x, t, ctx, sd, cfg):
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb = torch_timestep_embedding(
        t, chans[0], cfg.flip_sin_to_cos, cfg.freq_shift
    )
    temb = _lin(temb, sd, "time_embedding.linear_1")
    temb = _lin(F.silu(temb), sd, "time_embedding.linear_2")
    h = _conv(x, sd, "conv_in")
    skips = [h]
    for i in range(n):
        for j in range(cfg.layers_per_block):
            h = torch_resnet(h, temb, sd, f"down_blocks.{i}.resnets.{j}")
            if cfg.attn_down[i]:
                h = torch_t2d(
                    h, ctx, sd, f"down_blocks.{i}.attentions.{j}",
                    cfg.num_heads[i], cfg.use_linear_projection,
                )
            skips.append(h)
        if i < n - 1:
            h = _conv(
                h, sd, f"down_blocks.{i}.downsamplers.0.conv",
                stride=2, padding=1,
            )
            skips.append(h)
    h = torch_resnet(h, temb, sd, "mid_block.resnets.0")
    h = torch_t2d(
        h, ctx, sd, "mid_block.attentions.0", cfg.num_heads[-1],
        cfg.use_linear_projection,
    )
    h = torch_resnet(h, temb, sd, "mid_block.resnets.1")
    for i in range(n):
        level = n - 1 - i
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = torch_resnet(h, temb, sd, f"up_blocks.{i}.resnets.{j}")
            if cfg.attn_up[i]:
                h = torch_t2d(
                    h, ctx, sd, f"up_blocks.{i}.attentions.{j}",
                    cfg.num_heads[level], cfg.use_linear_projection,
                )
        if i < n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(h, sd, f"up_blocks.{i}.upsamplers.0.conv")
    h = F.silu(_gn(h, sd, "conv_norm_out", 32, cfg.norm_eps))
    return _conv(h, sd, "conv_out")


@pytest.mark.parametrize("linear", [True, False])
def test_full_unet_matches_torch(linear):
    """Complete tiny UNet (both projection generations) through
    convert_unet_state_dict: timestep embedding, every block family, skip
    ordering, head layout — value-level vs the torch mirror."""
    cfg = dataclasses.replace(
        UNet2DConfig.tiny(), use_linear_projection=linear
    )
    sd = _build_unet_sd(cfg, seed=10 if linear else 11)
    model = UNet2DConditionModel(cfg)

    x = sd._t(2, cfg.in_channels, 16, 16)
    t = torch.tensor([981, 21])
    ctx = sd._t(2, 7, cfg.cross_attention_dim)
    ref = _nchw_ref(torch_unet(x, t, ctx, sd, cfg))

    params = W.convert_unet_state_dict(_to_np(sd))
    expected = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, 16, 16, cfg.in_channels), jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((1, 7, cfg.cross_attention_dim), jnp.float32),
        )
    )
    W.assert_params_match(params, expected["params"])

    eps, cache = model.apply(
        {"params": params},
        _nhwc(x),
        jnp.asarray(t.numpy()),
        jnp.asarray(ctx.numpy(), jnp.float32),
    )
    assert cache == {}
    np.testing.assert_allclose(eps, ref, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# ControlNet (encoder half of the UNet + cond embedder + projection convs)
# ---------------------------------------------------------------------------


def _build_controlnet_sd(cfg, seed=12):
    """diffusers ControlNetModel state dict (diffusers key names): the UNet
    encoder half, the ControlNetConditioningEmbedding chain (channels
    16->32->96->256, three stride-2 downsamples = the x8 latent factor),
    and the per-skip 1x1 projection convs. The projections are zero-init in
    a fresh diffusers model; random values here so the golden is
    value-sensitive (trained checkpoints have non-zero values).
    Reference consumer: preprocess.py:60-68,129-149."""
    sd = _SD(seed)
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb_dim = chans[0] * 4
    sd.conv("conv_in", cfg.in_channels, chans[0])
    sd.lin("time_embedding.linear_1", chans[0], temb_dim)
    sd.lin("time_embedding.linear_2", temb_dim, temb_dim)
    cond_ch = (16, 32, 96, 256)
    sd.conv("controlnet_cond_embedding.conv_in", 3, cond_ch[0])
    for i in range(len(cond_ch) - 1):
        sd.conv(
            f"controlnet_cond_embedding.blocks.{2 * i}",
            cond_ch[i], cond_ch[i],
        )
        sd.conv(
            f"controlnet_cond_embedding.blocks.{2 * i + 1}",
            cond_ch[i], cond_ch[i + 1],
        )
    sd.conv("controlnet_cond_embedding.conv_out", cond_ch[-1], chans[0])
    cin = chans[0]
    skip_ch = [chans[0]]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            sd.resnet(f"down_blocks.{i}.resnets.{j}", cin, ch, temb_dim)
            cin = ch
            if cfg.attn_down[i]:
                sd.t2d(
                    f"down_blocks.{i}.attentions.{j}", ch,
                    cfg.cross_attention_dim, cfg.use_linear_projection,
                )
            skip_ch.append(ch)
        if i < n - 1:
            sd.conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
            skip_ch.append(ch)
    sd.resnet("mid_block.resnets.0", chans[-1], chans[-1], temb_dim)
    sd.t2d(
        "mid_block.attentions.0", chans[-1], cfg.cross_attention_dim,
        cfg.use_linear_projection,
    )
    sd.resnet("mid_block.resnets.1", chans[-1], chans[-1], temb_dim)
    for i, ch in enumerate(skip_ch):
        sd.conv(f"controlnet_down_blocks.{i}", ch, ch, k=1)
    sd.conv("controlnet_mid_block", chans[-1], chans[-1], k=1)
    return sd


def torch_controlnet(x, t, ctx, cond, sd, cfg, scale=1.0):
    """diffusers ControlNetModel.forward semantics: encoder pass with the
    cond embedding added after conv_in, each skip (and the mid output)
    through its projection conv, everything scaled by
    conditioning_scale."""
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb = torch_timestep_embedding(
        t, chans[0], cfg.flip_sin_to_cos, cfg.freq_shift
    )
    temb = _lin(temb, sd, "time_embedding.linear_1")
    temb = _lin(F.silu(temb), sd, "time_embedding.linear_2")
    h = _conv(x, sd, "conv_in")
    c = F.silu(_conv(cond, sd, "controlnet_cond_embedding.conv_in"))
    for i in range(3):
        c = F.silu(
            _conv(c, sd, f"controlnet_cond_embedding.blocks.{2 * i}")
        )
        c = F.silu(
            _conv(
                c, sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}",
                stride=2,
            )
        )
    h = h + _conv(c, sd, "controlnet_cond_embedding.conv_out")
    skips = [h]
    for i in range(n):
        for j in range(cfg.layers_per_block):
            h = torch_resnet(h, temb, sd, f"down_blocks.{i}.resnets.{j}")
            if cfg.attn_down[i]:
                h = torch_t2d(
                    h, ctx, sd, f"down_blocks.{i}.attentions.{j}",
                    cfg.num_heads[i], cfg.use_linear_projection,
                )
            skips.append(h)
        if i < n - 1:
            h = _conv(
                h, sd, f"down_blocks.{i}.downsamplers.0.conv",
                stride=2, padding=1,
            )
            skips.append(h)
    h = torch_resnet(h, temb, sd, "mid_block.resnets.0")
    h = torch_t2d(
        h, ctx, sd, "mid_block.attentions.0", cfg.num_heads[-1],
        cfg.use_linear_projection,
    )
    h = torch_resnet(h, temb, sd, "mid_block.resnets.1")
    down = [
        _conv(s, sd, f"controlnet_down_blocks.{i}", padding=0) * scale
        for i, s in enumerate(skips)
    ]
    mid = _conv(h, sd, "controlnet_mid_block", padding=0) * scale
    return down, mid


def test_full_controlnet_matches_torch():
    """Complete tiny ControlNet through convert_controlnet_state_dict —
    cond-embedding chain, encoder skips, projection convs — value-level vs
    the torch mirror (previously ControlNet had only shape/zero-init
    tests)."""
    from tokenflow_tpu.models.controlnet import ControlNetModel

    cfg = UNet2DConfig.tiny()
    sd = _build_controlnet_sd(cfg, seed=12)
    model = ControlNetModel(cfg)

    hw = 16
    x = sd._t(2, cfg.in_channels, hw, hw)
    t = torch.tensor([981, 21])
    ctx = sd._t(2, 7, cfg.cross_attention_dim)
    cond = sd._t(2, 3, hw * 8, hw * 8, scale=0.5)
    ref_down, ref_mid = torch_controlnet(x, t, ctx, cond, sd, cfg, scale=0.7)

    params = W.convert_controlnet_state_dict(_to_np(sd))
    expected = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, hw, hw, cfg.in_channels), jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((1, 7, cfg.cross_attention_dim), jnp.float32),
            jnp.zeros((1, hw * 8, hw * 8, 3), jnp.float32),
        )
    )
    W.assert_params_match(params, expected["params"])

    down, mid = model.apply(
        {"params": params},
        _nhwc(x),
        jnp.asarray(t.numpy()),
        jnp.asarray(ctx.numpy(), jnp.float32),
        _nhwc(cond),
        conditioning_scale=0.7,
    )
    assert len(down) == len(ref_down)
    for got, want in zip(down, ref_down):
        np.testing.assert_allclose(
            got, _nchw_ref(want), rtol=2e-3, atol=2e-4
        )
    np.testing.assert_allclose(
        mid, _nchw_ref(ref_mid), rtol=2e-3, atol=2e-4
    )

"""One edit step and one inversion step of the reference, from the state the
program held before the step and the harness's inputs."""

from __future__ import annotations

import torch

from reference import model as M
from reference.precision import Precision

# frames per reference UNet call of the propagation pass and the inversion
# (each frame's output depends only on its own inputs and the cache)
FRAMES_PER_CALL = 10


def _streams(*parts):
    """k (F, ...) tensors -> (k F, ...) frame-major."""
    return torch.stack(parts, dim=1).reshape(-1, *parts[0].shape[1:])


def _ddim(x, eps, alpha_t, alpha_prev):
    a_t = torch.tensor(float(alpha_t), dtype=torch.float32, device=x.device)
    a_p = torch.tensor(float(alpha_prev), dtype=torch.float32, device=x.device)
    x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(1 - a_p) * eps


def _residuals(P, controlnet, sample, t, ctx, cond):
    if controlnet is None:
        return {}
    down, mid = M.controlnet_forward(P, controlnet, sample, t, ctx, cond)
    return {"down_residuals": down, "mid_residual": mid}


@torch.no_grad()
def edit_step(P: Precision, unet, controlnet, x, src, embeds3, tables: dict, i: int,
              pivots, traffic: dict, cond=None, pa=None, pb=None, w1=None):
    """x after edit step ``i`` (fp32), from ``x`` (F, h, w, 4), the source
    trajectory's latents at step i's slot ``src``, the [inversion | uncond
    | cond] embeddings, the step's pivot frames and, with a ControlNet, the
    conditioning images ``cond`` (F, H, W, 3)."""
    x, src = x.float(), src.float()
    f = x.shape[0]
    piv = torch.as_tensor(pivots, dtype=torch.long, device=x.device)
    k = len(piv)
    t = int(tables["t"][i])
    pnp = traffic.get("editor") == "pnp"
    gates = dict(pnp=pnp, qk_gate=bool(tables["qk_gate"][i]),
                 conv_gate=bool(tables["conv_gate"][i]))
    sample = _streams(src[piv], x[piv], x[piv])
    ctx = embeds3.float().repeat(k, 1, 1)
    res = _residuals(P, controlnet, sample, t, ctx,
                     None if cond is None else cond[piv].repeat_interleave(3, dim=0))
    _, cache = M.unet_forward(P, unet, sample, t, ctx, M.Edit("pivotal", k, 3, **gates), **res)
    eps = []
    for c0 in range(0, f, FRAMES_PER_CALL):
        sl = slice(c0, c0 + FRAMES_PER_CALL)
        n = len(x[sl])
        sample = _streams(src[sl], x[sl], x[sl])
        ctx = embeds3.float().repeat(n, 1, 1)
        res = _residuals(P, controlnet, sample, t, ctx,
                         None if cond is None else cond[sl].repeat_interleave(3, dim=0))
        edit = M.Edit("propagate", n, 3, cache=cache, pa=pa[sl], pb=pb[sl], w1=w1[sl],
                      **gates)
        e, _ = M.unet_forward(P, unet, sample, t, ctx, edit, **res)
        e3 = e.reshape(n, 3, *e.shape[1:])
        eps.append(e3[:, 1] + traffic["guidance_scale"] * (e3[:, 2] - e3[:, 1]))
    return _ddim(x, torch.cat(eps), tables["alpha_t"][i], tables["alpha_prev"][i])


@torch.no_grad()
def inversion_step(P: Precision, unet, controlnet, x, cond_embed, tables: dict, i: int,
                   cond=None):
    """x after inversion step ``i`` (fp32): conditional-only eps on the
    inversion prompt's embedding ``cond_embed`` (1, 77, C)."""
    x = x.float()
    t = int(tables["t"][i])
    eps = []
    for c0 in range(0, x.shape[0], FRAMES_PER_CALL):
        xs = x[c0 : c0 + FRAMES_PER_CALL]
        ctx = cond_embed.float().expand(len(xs), -1, -1)
        res = _residuals(P, controlnet, xs, t, ctx,
                         None if cond is None else cond[c0 : c0 + FRAMES_PER_CALL])
        eps.append(M.unet_forward(P, unet, xs, t, ctx, **res)[0])
    eps = torch.cat(eps)
    a_t, a_p = (torch.tensor(float(tables[k][i]), dtype=torch.float32, device=x.device)
                for k in ("alpha_t", "alpha_prev"))
    x0 = (x - torch.sqrt(1 - a_p) * eps) / torch.sqrt(a_p)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1 - a_t) * eps

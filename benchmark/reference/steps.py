"""One edit step and one inversion step of the reference, from the state the
program held before the step and the harness's inputs. The models are the
architecture's reference modules (``architectures/<name>.py::reference_model``),
called as ``unet(P, sample, t, context, edit, down_residuals, mid_residual,
**model_kw)`` and ``controlnet(P, sample, t, context, cond, **model_kw)``;
``model_kw`` holds the architecture's inputs beyond the prompt embeddings,
one row per prompt, batched as the embeddings are.

The model's output is what the tables' ``prediction_type`` says. Guidance
combines the outputs as they are (it is affine in them, and the guided
streams share x, so guiding v and converting equals guiding eps); the
DDIM update then reads eps and x0 from the guided output at the level the
sample sits at: an edit step's ``alpha_t``, an inversion step's
``alpha_prev`` (diffusers' DDIMInverseScheduler). For v-prediction
x0 = sqrt(a) x - sqrt(1 - a) v and eps = sqrt(a) v + sqrt(1 - a) x.

Under rectified flow (``prediction_type`` "flow") the output is the
velocity, the model is called with the float t = sigma N, and the Euler
step moves the sample by (sigma_next - sigma) times the guided velocity, in
fp32 (diffusers' FlowMatchEulerDiscreteScheduler.step). The DDIM paths
call the model with ``int(t)``."""

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


def _ddim(x, out, alpha_from, alpha_to, prediction: str):
    """DDIM (eta 0) from the level ``alpha_from`` that ``x`` sits at to
    ``alpha_to``, on the model's output ``out`` of kind ``prediction``."""
    a_f = torch.tensor(float(alpha_from), dtype=torch.float32, device=x.device)
    a_to = torch.tensor(float(alpha_to), dtype=torch.float32, device=x.device)
    if prediction == "v_prediction":
        eps = torch.sqrt(a_f) * out + torch.sqrt(1 - a_f) * x
        x0 = torch.sqrt(a_f) * x - torch.sqrt(1 - a_f) * out
    else:
        eps = out
        x0 = (x - torch.sqrt(1 - a_f) * eps) / torch.sqrt(a_f)
    return torch.sqrt(a_to) * x0 + torch.sqrt(1 - a_to) * eps


def _edit_update(x, out, tables: dict, i: int):
    """Edit step ``i``'s update on the guided output ``out``: DDIM from
    alpha_t to alpha_prev, or the Euler step of rectified flow from sigma
    to sigma_next on the velocity."""
    if tables["prediction_type"] != "flow":
        return _ddim(x, out, tables["alpha_t"][i], tables["alpha_prev"][i],
                     tables["prediction_type"])
    s, s_next = (torch.tensor(float(tables[k][i]), dtype=torch.float32, device=x.device)
                 for k in ("sigma", "sigma_next"))
    return x + (s_next - s) * out


def _residuals(P, controlnet, sample, t, ctx, cond, kw):
    if controlnet is None:
        return {}
    down, mid = controlnet(P, sample, t, ctx, cond, **kw)
    return {"down_residuals": down, "mid_residual": mid}


def _repeat(model_kw: dict, n: int) -> dict:
    """The per-prompt inputs for ``n`` frames of every prompt, frame-major."""
    return {k: v.repeat(n, *[1] * (v.dim() - 1)) for k, v in model_kw.items()}


@torch.no_grad()
def edit_step(P: Precision, unet, controlnet, x, src, embeds3, tables: dict, i: int,
              pivots, traffic: dict, inject: tuple, cond=None, pa=None, pb=None, w1=None,
              model_kw=None):
    """x after edit step ``i`` (fp32), from ``x`` (F, h, w, 4), the source
    trajectory's latents at step i's slot ``src``, the [inversion | uncond
    | cond] embeddings, the step's pivot frames, the PnP sites ``inject``
    (q and k sites, feature site) and, with a ControlNet, the conditioning
    images ``cond`` (F, H, W, 3)."""
    x, src = x.float(), src.float()
    model_kw = model_kw or {}
    f = x.shape[0]
    piv = torch.as_tensor(pivots, dtype=torch.long, device=x.device)
    k = len(piv)
    t = float(tables["t"][i]) if tables["prediction_type"] == "flow" else int(tables["t"][i])
    pnp = traffic.get("editor") == "pnp"
    gates = dict(pnp=pnp, qk_gate=bool(tables["qk_gate"][i]),
                 conv_gate=bool(tables["conv_gate"][i]), qk_sites=inject[0],
                 conv_site=inject[1])
    sample = _streams(src[piv], x[piv], x[piv])
    ctx = embeds3.float().repeat(k, 1, 1)
    kw = _repeat(model_kw, k)
    res = _residuals(P, controlnet, sample, t, ctx,
                     None if cond is None else cond[piv].repeat_interleave(3, dim=0), kw)
    _, cache = unet(P, sample, t, ctx, M.Edit("pivotal", k, 3, **gates), **res, **kw)
    out = []
    for c0 in range(0, f, FRAMES_PER_CALL):
        sl = slice(c0, c0 + FRAMES_PER_CALL)
        n = len(x[sl])
        sample = _streams(src[sl], x[sl], x[sl])
        ctx = embeds3.float().repeat(n, 1, 1)
        kw = _repeat(model_kw, n)
        res = _residuals(P, controlnet, sample, t, ctx,
                         None if cond is None else cond[sl].repeat_interleave(3, dim=0), kw)
        edit = M.Edit("propagate", n, 3, cache=cache, pa=pa[sl], pb=pb[sl], w1=w1[sl],
                      **gates)
        e, _ = unet(P, sample, t, ctx, edit, **res, **kw)
        e3 = e.reshape(n, 3, *e.shape[1:])
        out.append(e3[:, 1] + traffic["guidance_scale"] * (e3[:, 2] - e3[:, 1]))
    return _edit_update(x, torch.cat(out), tables, i)


@torch.no_grad()
def inversion_step(P: Precision, unet, controlnet, x, cond_embed, tables: dict, i: int,
                   cond=None, model_kw=None):
    """x after inversion step ``i`` (fp32): the conditional-only output on
    the inversion prompt's embedding ``cond_embed`` (1, 77, C)."""
    x = x.float()
    model_kw = model_kw or {}
    t = int(tables["t"][i])
    out = []
    for c0 in range(0, x.shape[0], FRAMES_PER_CALL):
        xs = x[c0 : c0 + FRAMES_PER_CALL]
        ctx = cond_embed.float().expand(len(xs), -1, -1)
        kw = _repeat(model_kw, len(xs))
        res = _residuals(P, controlnet, xs, t, ctx,
                         None if cond is None else cond[c0 : c0 + FRAMES_PER_CALL], kw)
        out.append(unet(P, xs, t, ctx, **res, **kw)[0])
    return _ddim(x, torch.cat(out), tables["alpha_prev"][i], tables["alpha_t"][i],
                 tables["prediction_type"])

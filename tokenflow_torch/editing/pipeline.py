"""The TokenFlow edit loop, the counterpart of
``tokenflow_tpu/editing/pipeline.py``, and the per-frame SDEdit baseline
(:func:`vanilla_sample_loop`).

Per denoising step:
  1. pivotal pass: one UNet call over the keyframes (3-stream
     [source|uncond|cond] frame-major batch) with extended attention,
     returning the per-site cache {pivot_h, kf_attn};
  2. propagation pass: the UNet over all frames (optionally in chunks of
     ``propagate_chunk`` frames) with self-attention replaced by the NN
     token propagation from the cache;
  3. classifier-free guidance and a DDIM step.
With a ``controlnet_fn``, both passes add ControlNet residuals computed on
their own batch (the conditioning images of their frames, one per stream).
``prop_approx`` (NON-PARITY) makes the propagation pass source-free
([uncond|cond]), and the pivotal pass too without PnP. ``fused`` runs
both passes as one UNet call a step (``EditMode.FUSED``), save where the
JAX loop falls back to two (:func:`fused_fallback`). With per-frame
``depth`` maps (the 5-channel depth UNet), every stream of both passes
carries its frame's map as a fifth channel. Over a frames group
(``sharding/mesh.py``) both loops run on the rank's block of the frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Optional

import numpy as np
import torch

from tokenflow_torch.diffusion import ddim
from tokenflow_torch.ops import editctx
from tokenflow_torch.ops.propagation import propagation_indices
from tokenflow_torch.sharding import mesh
from tokenflow_torch.utils import segment_slices

# unet_apply(sample, t, context, edit, **residuals) -> (eps, cache)
UNetApply = Callable[..., tuple]
# controlnet_fn(sample, t, context, cond) -> (down residuals, mid residual)
ControlNetFn = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class EditSchedule:
    """Per-step host tables driving the edit loop."""

    timesteps: np.ndarray  # (T,) descending
    alpha_t: np.ndarray  # (T,)
    alpha_prev: np.ndarray  # (T,)
    src_slot: np.ndarray  # (T,) index into the latent trajectory
    qk_gate: np.ndarray  # (T,) bool
    conv_gate: np.ndarray  # (T,) bool


def split_schedule(schedule: EditSchedule, seg_len: int) -> list[EditSchedule]:
    """The per-step tables cut into contiguous segments of at most
    ``seg_len`` steps (``tokenflow_tpu/editing/pipeline.py::split_schedule``).
    Running :func:`tokenflow_sample_loop` per segment, each on the previous
    segment's latents and its slice of the pivot table, is the same
    computation as one call: the segments are where a checkpointed edit
    can stop and resume."""
    if seg_len <= 0:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    fields = [f.name for f in dataclasses.fields(EditSchedule)]
    return [
        EditSchedule(**{k: getattr(schedule, k)[s] for k in fields})
        for s in segment_slices(len(schedule.timesteps), seg_len)
    ]


def make_edit_schedule(
    sched: ddim.DDIMSchedule,
    save_timesteps: np.ndarray,
    *,
    pnp_attn_t: float = 0.0,
    pnp_f_t: float = 0.0,
) -> EditSchedule:
    """The per-step tables. The first ``int(n_timesteps * frac)`` steps
    inject (reference run_tokenflow_pnp.py:235-240, 254-256; the fraction
    is of the full n_timesteps)."""
    ts = sched.timesteps
    slot_of = {int(t): i for i, t in enumerate(save_timesteps)}
    missing = [int(t) for t in ts if int(t) not in slot_of]
    if missing:
        raise ValueError(
            f"edit timesteps {missing} not on the inversion save grid "
            f"(reference asserts the same, tokenflow_utils.py:45)"
        )
    alpha_t, alpha_prev = sched.step_alphas()
    n_full = sched.num_inference_steps
    idx = np.arange(len(ts))
    return EditSchedule(
        timesteps=ts.astype(np.int32),
        alpha_t=alpha_t,
        alpha_prev=alpha_prev,
        src_slot=np.asarray([slot_of[int(t)] for t in ts], np.int32),
        qk_gate=idx < int(n_full * pnp_attn_t),
        conv_gate=idx < int(n_full * pnp_f_t),
    )


def choose_pivots(
    generator: torch.Generator, n_steps: int, n_windows: int, window_size: int
) -> np.ndarray:
    """Per-step random pivots, (n_steps, n_windows) absolute frame indices
    (pivot of window w in [w*ws, (w+1)*ws)); the reference draws
    ``randint(batch_size) + arange(0, n, bs)`` per step
    (run_tokenflow_pnp.py:224). Drawn on the CPU generator given."""
    draw = torch.randint(0, window_size, (n_steps, n_windows), generator=generator)
    offsets = np.arange(n_windows, dtype=np.int32) * window_size
    return draw.numpy().astype(np.int32) + offsets[None, :]


def validate_pivot_indices(
    pivots, n_steps: int, n_windows: int, window_size: int
) -> np.ndarray:
    """Check a pinned pivot table: shape, and each pivot inside its window."""
    pivots = np.asarray(pivots, np.int32)
    if pivots.shape != (n_steps, n_windows):
        raise ValueError(
            f"pivot_indices shape {pivots.shape} != "
            f"(n_steps={n_steps}, n_windows={n_windows})"
        )
    lo = np.arange(n_windows) * window_size
    if ((pivots < lo) | (pivots >= lo + window_size)).any():
        raise ValueError(
            "pivot_indices out of window: each pivots[t, w] must lie in "
            f"[w*{window_size}, (w+1)*{window_size})"
        )
    return pivots


def _stack_streams(*streams: torch.Tensor) -> torch.Tensor:
    """k stream tensors (F, ...) -> (k*F, ...) frame-major batch."""
    return torch.stack(streams, dim=1).reshape(-1, *streams[0].shape[1:])


def _with_depth(x: torch.Tensor, depth: Optional[torch.Tensor]) -> torch.Tensor:
    """x (F, h, w, 4) with the frames' depth maps (F, h, w, 1) as a fifth
    channel, in x's dtype."""
    if depth is None:
        return x
    return torch.cat([x, depth.to(x.dtype)], dim=-1)


def fused_fallback(n_frames: int, propagate_chunk: Optional[int], controlnet: bool,
                   prop_approx: bool) -> Optional[str]:
    """Why a ``fused`` loop over ``n_frames`` (a rank's) runs its two passes
    all the same, as the JAX loop's three conditions say
    (tokenflow_tpu/editing/pipeline.py:279-283): more than one propagate
    chunk, a ControlNet, or ``prop_approx``; None when it runs fused."""
    reasons = [name for name, on in (
        ("chunked", (propagate_chunk or n_frames) != n_frames),
        ("ControlNet", controlnet),
        ("prop_approx", prop_approx),
    ) if on]
    return " | ".join(reasons) or None


@torch.inference_mode()
def tokenflow_sample_loop(
    unet_apply: UNetApply,
    x_init: torch.Tensor,  # (F, h, w, 4) noisy start latents
    src_traj: torch.Tensor,  # (n_save, F, h, w, 4) inversion trajectory
    embeds3: torch.Tensor,  # (3, 77, D) [inversion | uncond | cond]
    schedule: EditSchedule,
    *,
    window_size: int,
    guidance_scale: float,
    pnp: bool,
    pivot_indices: np.ndarray,  # (T, n_windows) absolute frame indices
    propagate_chunk: Optional[int] = None,  # frames per propagation call
    phase: Callable[[str], ContextManager] = lambda name: contextlib.nullcontext(),
    controlnet_fn: Optional[ControlNetFn] = None,
    cond_image: Optional[torch.Tensor] = None,  # (F, H, W, 3) for controlnet_fn
    prop_approx: bool = False,
    depth: Optional[torch.Tensor] = None,  # (F, h, w, 1) for the depth UNet
    group: Optional[mesh.FramesGroup] = None,
    shard_pivotal: bool = True,
    fused: bool = False,
) -> torch.Tensor:
    """Run the TokenFlow edit; returns the denoised latents (F, h, w, 4) in
    x_init's dtype. ``phase(name)`` wraps each "pivotal" and "propagate"
    pass, or each "fused" step (a timing hook). ``controlnet_fn`` adds its
    residuals to every UNet call: the pivotal pass on
    ``cond_image[pivots]``, the propagation pass on its chunk's frames,
    each image repeated for the pass's streams frame-major
    (``jnp.repeat(cond, ns, axis=0)`` in the JAX loop).

    ``prop_approx`` (NON-PARITY, held to the JAX package's approximate
    loop, not to the exact one): the propagation pass runs [uncond|cond]
    and matches on uncond; under PnP the pivotal pass stays three-stream
    and also caches the uncond matching tables and the pivots' source conv
    features, without PnP it is [uncond|cond] too.

    ``depth`` (the 5-channel depth UNet): each stream's sample carries its
    frame's map, ``depth[pivots]`` in the pivotal pass and the chunk's maps
    in the propagation pass.

    ``group`` (a ``sharding.mesh.FramesGroup``): every frame-indexed input
    (``x_init``, ``src_traj`` along its axis 1, ``depth``, ``cond_image``)
    is this rank's block of the frames, and so is the result; the pivot
    table stays global. The pivotal pass takes its keyframes' rows from the
    ranks that own them (``mesh.take_frames``). With ``shard_pivotal`` (the
    JAX CLI's default) each rank runs it on its block of the keyframes
    (``mesh.split_counts``), its extended attention over all keyframes'
    K/V, and the cache is then gathered (``mesh.gather_cache``); without,
    every rank runs the whole pivotal pass. The propagation pass matches
    the rank's frames against the replicated cache with global pivot
    indices, in chunks of ``propagate_chunk`` of the rank's frames.

    ``fused`` (``tokenflow_tpu/editing/pipeline.py:328-366``): each step is
    one UNet call on ``[streams(src[piv], x[piv]) | streams(src, x)]``
    (``EditMode.FUSED``): at each site the pivots' extended attention
    makes the cache that the frames propagate from in the same call, and
    the frames' eps go to CFG. The same maths as the two passes, with
    other batch shapes. Under :func:`fused_fallback`'s conditions the loop
    runs the two passes. Over a frames group every rank runs the whole
    pivot segment (``mesh.take_frames``) beside its frames, so no K/V or
    cache is gathered and ``shard_pivotal`` does not apply.

    ``propagate_chunk`` must divide the (rank's) frames; unlike the JAX
    loop's, it need not be a multiple of the window, since every frame's
    pivot indices are global (the CLIs keep the JAX rule on the YAML key)."""
    world = 1 if group is None else group.world
    f_local = x_init.shape[0]
    f_total = f_local * world
    n_windows = f_total // window_size
    if n_windows * window_size != f_total:
        raise ValueError(f"{f_total} frames are not a multiple of {window_size}")
    # chunks need not align with windows: pa and pb are global indices
    chunk = propagate_chunk or f_local
    if f_local % chunk:
        raise ValueError(f"propagate_chunk {chunk} must divide {f_local} frames")
    n_steps = len(schedule.timesteps)
    pivots = validate_pivot_indices(pivot_indices, n_steps, n_windows, window_size)
    dev = x_init.device
    # the pivot indices stay on the host: the match wrappers check their range
    # there without a device sync and copy them over asynchronously
    lo = 0 if group is None else group.rank * f_local
    pa, pb, w1 = (torch.as_tensor(a[lo : lo + f_local])
                  for a in propagation_indices(f_total, window_size))
    w1 = w1.to(dev)
    # the pivotal pass: this rank's block of the keyframes, or all of them
    piv_group = group if shard_pivotal else None
    kf_counts = mesh.split_counts(n_windows, world) if piv_group is not None else None
    kf_block = (slice(None) if kf_counts is None else
                slice(sum(kf_counts[: group.rank]), sum(kf_counts[: group.rank + 1])))
    n_kf = n_windows if kf_counts is None else kf_counts[group.rank]
    # stream counts: the propagation pass drops the source under approx; the
    # pivotal pass too when nothing injects from it (no PnP)
    n_prop = 2 if prop_approx else 3
    src_free_piv = prop_approx and not pnp
    n_piv = 2 if src_free_piv else 3
    # frame-major [inv, uncond, cond] (or [uncond, cond]) per frame
    embeds_piv = (embeds3[1:] if src_free_piv else embeds3).repeat(n_kf, 1, 1)
    embeds_prop = (embeds3[1:] if prop_approx else embeds3).repeat(chunk, 1, 1)
    if (controlnet_fn is None) != (cond_image is None):
        raise ValueError("controlnet_fn and cond_image come together")
    fused = fused and fused_fallback(f_local, propagate_chunk, controlnet_fn is not None,
                                     prop_approx) is None
    # the fused batch: frame-major [inv, uncond, cond] for the K pivots, then
    # for the rank's frames
    embeds_fused = embeds3.repeat(n_windows + f_local, 1, 1) if fused else None

    def residuals(sample, t, embeds, cond, ns):
        """ControlNet residuals of an ns-stream pass (the reference's 3x
        concat of the conditioning)."""
        if controlnet_fn is None:
            return {}
        down, mid = controlnet_fn(sample, t, embeds, cond.repeat_interleave(ns, dim=0))
        return dict(down_block_residuals=down, mid_block_residual=mid)

    def streams(src, x_f, ns, d):
        parts = (x_f, x_f) if ns == 2 else (src, x_f, x_f)
        return _stack_streams(*(_with_depth(p, d) for p in parts))

    def part(a, sel):
        return None if a is None else a[sel]

    def keyframes(a, piv):
        """Rows ``piv`` of a frame-indexed input, this rank's block of them."""
        return None if a is None else mesh.take_frames(group, a, piv)[kf_block]

    x = x_init
    for i in range(n_steps):
        t = int(schedule.timesteps[i])
        qk_g, conv_g = bool(schedule.qk_gate[i]), bool(schedule.conv_gate[i])
        src = src_traj[int(schedule.src_slot[i])]
        piv = pivots[i]

        if fused:
            with phase("fused"):
                def take(a):
                    return None if a is None else mesh.take_frames(group, a, piv)

                sample = torch.cat([streams(take(src), take(x), 3, take(depth)),
                                    streams(src, x, 3, depth)])
                edit = editctx.UNetEdit(
                    mode=editctx.EditMode.FUSED, n_frames=f_local, n_pivots=n_windows,
                    pnp=pnp, qk_gate=qk_g, conv_gate=conv_g,
                    prop_pa=pa, prop_pb=pb, prop_w1=w1, group=group,
                )
                eps_all, _ = unet_apply(sample, t, embeds_fused, edit)
                eps3 = eps_all[3 * n_windows :].reshape(f_local, 3, *eps_all.shape[1:])
                eps = ddim.classifier_free_guidance(eps3[:, 1], eps3[:, 2], guidance_scale)
                x = ddim.ddim_step(
                    x, eps, schedule.alpha_t[i], schedule.alpha_prev[i]
                ).to(x.dtype)
            continue

        with phase("pivotal"):
            edit_piv = editctx.UNetEdit(
                mode=editctx.EditMode.PIVOTAL, n_frames=n_kf, pnp=pnp,
                prop_approx=prop_approx, qk_gate=qk_g, conv_gate=conv_g,
                group=piv_group, kf_counts=kf_counts,
            )
            # the pivot eps is discarded; only the cache matters (reference
            # run_tokenflow_pnp.py:227)
            sample = streams(keyframes(src, piv) if n_piv == 3 else None,
                             keyframes(x, piv), n_piv, keyframes(depth, piv))
            _, cache = unet_apply(
                sample, t, embeds_piv, edit_piv,
                **residuals(sample, t, embeds_piv, keyframes(cond_image, piv), n_piv),
            )
            cache = mesh.gather_cache(piv_group, cache, kf_counts)

        with phase("propagate"):
            eps3 = []
            for c0 in range(0, f_local, chunk):
                sl = slice(c0, c0 + chunk)
                edit = editctx.UNetEdit(
                    mode=editctx.EditMode.PROPAGATE, n_frames=chunk, pnp=pnp,
                    prop_approx=prop_approx, qk_gate=qk_g, conv_gate=conv_g,
                    cache=cache, prop_pa=pa[sl], prop_pb=pb[sl], prop_w1=w1[sl],
                    group=group,
                )
                sample = streams(src[sl], x[sl], n_prop, part(depth, sl))
                eps_c, _ = unet_apply(
                    sample, t, embeds_prop, edit,
                    **residuals(sample, t, embeds_prop, part(cond_image, sl), n_prop),
                )
                eps3.append(eps_c.reshape(chunk, n_prop, *eps_c.shape[1:]))
            eps3 = torch.cat(eps3)
            # CFG on streams (1, 2) of [source|uncond|cond], (0, 1) of the
            # approximate pass's [uncond|cond] (tokenflow_tpu/editing/pipeline.py:476)
            u, c = (0, 1) if prop_approx else (1, 2)
            eps = ddim.classifier_free_guidance(eps3[:, u], eps3[:, c], guidance_scale)
            x = ddim.ddim_step(
                x, eps, schedule.alpha_t[i], schedule.alpha_prev[i]
            ).to(x.dtype)
    return x


@torch.inference_mode()
def vanilla_sample_loop(
    unet_apply: UNetApply,
    x_init: torch.Tensor,  # (F, h, w, 4) noisy start latents
    embeds2: torch.Tensor,  # (2, 77, D) [uncond | cond]
    schedule: EditSchedule,
    *,
    guidance_scale: float,
    frame_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Per-frame SDEdit baseline (no TokenFlow): 2-stream [uncond|cond] CFG
    sampling over chunks of ``frame_chunk`` frames (the JAX ``lax.map``
    over chunks, tokenflow_tpu/editing/pipeline.py:498-542). Returns the
    denoised latents in x_init's dtype. Every frame is independent, so over
    a frames group each rank passes its block of the frames (the JAX
    package's sharded vanilla loop, ``tests/test_sharding.py``) and no rank
    talks to another."""
    f_total = x_init.shape[0]
    chunk = frame_chunk or f_total
    if f_total % chunk:
        raise ValueError(f"frame_chunk {chunk} must divide {f_total} frames")
    embeds = embeds2.repeat(chunk, 1, 1)  # frame-major [uncond, cond]
    x = x_init
    for i in range(len(schedule.timesteps)):
        t = int(schedule.timesteps[i])
        eps = []
        for c0 in range(0, f_total, chunk):
            x_c = x[c0 : c0 + chunk]
            eps2, _ = unet_apply(_stack_streams(x_c, x_c), t, embeds, None)
            eps2 = eps2.reshape(chunk, 2, *eps2.shape[1:])
            eps.append(ddim.classifier_free_guidance(eps2[:, 0], eps2[:, 1], guidance_scale))
        x = ddim.ddim_step(
            x, torch.cat(eps), schedule.alpha_t[i], schedule.alpha_prev[i]
        ).to(x.dtype)
    return x

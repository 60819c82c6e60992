"""Preprocess CLI of the PyTorch port: DDIM-invert a video's frames and
store the latent trajectory (stage 1 of the two-stage pipeline).

    python -m tokenflow_torch.cli.preprocess --data_path data/<video> ...

Same flags (the main-path subset), defaults and save layout as
``tokenflow_tpu/cli/preprocess.py``: ``latents/sd_{ver}/{video}/steps_{N}/
nframes_{F}/latents/trajectory.npz`` plus ``inverted.mp4`` and the
reconstructed ``frames/``. ``--device`` is ``cuda`` (default) or ``cpu``,
``--dtype`` ``bf16`` (default) or ``f32`` on either. ``--sd_version
ControlNet`` (and its tiny test stack ``tiny-controlnet``) adds the
residuals of a canny ControlNet (``--controlnet_dir``, else random weights)
to every UNet call. ``--sd_version depth`` (and ``tiny-depth``) runs the
5-channel SD-2-depth UNet with each frame's depth map as the fifth latent
channel: maps from ``{data_path}/depth/%05d.npy``, else the port's DPT on
``--depth_model_dir`` (an Intel/dpt-large checkpoint), else MiDaS through
torch.hub (``tokenflow_torch/io/depth.py``).

``--checkpoint_inversion`` writes the inversion's carry to
``<save_path>/inversion_checkpoint.npz`` at segment boundaries
(``--steps_per_dispatch`` steps each, every ``--checkpoint_every``-th) and
resumes a matching interrupted run from it; the segments compute what one
loop computes. ``--then_edit <yaml>`` runs the editor that the YAML names
(PnP, SDEdit or ControlNet, inferred before the inversion starts) in this
process afterwards, on the same held model stack.

``--data_parallel`` (``auto``, ``off`` or N; ``cli/common.py``) shards the
frames over the processes a launcher started: each rank encodes, inverts
and reconstructs its block of the frames, and rank 0 gathers and writes
the trajectory, the frames and the mp4. ``--then_edit`` runs the editor on
the same ranks.

    torchrun --nproc_per_node 2 -m tokenflow_torch.cli.preprocess --data_parallel 2 ...
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from tokenflow_torch import runtime, utils
from tokenflow_torch.cli import common as cli_common
from tokenflow_torch.cli import controlnet_utils
from tokenflow_torch.cli.common import DTYPES
from tokenflow_torch.diffusion import ddim, inversion
from tokenflow_torch.io import depth as depth_io
from tokenflow_torch.io import latents as latents_io
from tokenflow_torch.io import video as video_io
from tokenflow_torch.sharding import mesh


def build_eps_fn(
    stack: runtime.SDStack,
    cond: torch.Tensor,
    frame_chunk=None,
    controlnet=None,
    canny=None,
    depth=None,
):
    """Conditional-only eps (no CFG during inversion, reference
    preprocess.py:271), over frame chunks of ``frame_chunk`` (the
    reference's frame micro-batching, preprocess.py:203). With a
    ``controlnet``, its residuals on the per-frame ``canny`` images are
    added to every UNet call (reference preprocess.py:129-149); per-frame
    ``depth`` maps (F, h, w, 1) are concatenated to x as a fifth channel in
    the stack's dtype (reference preprocess.py:207-209). Both chunk together
    with x."""

    def single(x, t, cn, d):
        ctx = cond.expand(x.shape[0], *cond.shape[1:])
        sample = x
        if d is not None:
            sample = torch.cat([x.to(stack.dtype), d.to(stack.dtype)], dim=-1)
        residuals = {}
        if controlnet is not None:
            down, mid = controlnet(sample, t, ctx, cn)
            residuals = dict(down_block_residuals=down, mid_block_residual=mid)
        eps, _ = stack.unet_apply(sample, t, ctx, None, **residuals)
        return eps

    def part(a, sl):
        return None if a is None else a[sl]

    def eps_fn(x, t):
        f = x.shape[0]
        if not frame_chunk or f <= frame_chunk:
            return single(x, t, canny, depth)
        return torch.cat([
            single(x[sl], t, part(canny, sl), part(depth, sl))
            for sl in (slice(i, i + frame_chunk) for i in range(0, f, frame_chunk))
        ])

    return eps_fn


def load_depth_maps(data_path: str, n_frames: int, latent_hw, *, model_dir=None,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """The frames' depth maps at the latent size, (F, h, w, 1) fp32 on
    ``device`` (``io/depth.py``: precomputed maps, the DPT on
    ``model_dir``, then torch.hub)."""
    maps = depth_io.load_or_compute_depth(
        data_path, n_frames, latent_hw, model_dir=model_dir, device=device
    )
    return torch.as_tensor(maps, device=device)


def _inversion_fingerprint(opt, slices: list, identity: dict) -> str:
    """Identity of an inversion run for checkpoint/resume: the JAX keys
    (``tokenflow_tpu/cli/preprocess.py::_inversion_fingerprint``) and the
    segment lengths, plus the port's ``dtype`` and ``group_norm_kernel`` and
    the stack's ``identity`` (weights and the prompt's token ids,
    ``cli_common.stack_identity``), so that a checkpoint never seeds a run
    of another schedule, prompt, geometry, weights or numerics."""
    ident = {
        k: getattr(opt, k, None)
        for k in (
            "sd_version", "inversion_prompt", "steps", "save_steps",
            "n_frames", "H", "W", "batch_size", "steps_per_dispatch",
            "data_path", "dtype", "group_norm_kernel",
        )
    }
    ident["segment_steps"] = [s.stop - s.start for s in slices]
    ident.update(identity)
    return hashlib.sha256(json.dumps(ident, sort_keys=True).encode()).hexdigest()


def infer_editor_family(cfg: dict, config_path: str) -> str:
    """The editor a stage-2 config is for: ``pnp_attn_t`` -> PnP, ``start``
    -> SDEdit, a ControlNet ``sd_version`` -> ControlNet
    (``tokenflow_tpu/cli/preprocess.py::infer_editor_family``); anything
    else raises ValueError, so ``--then_edit`` fails before the inversion."""
    if "pnp_attn_t" in cfg:
        return "pnp"
    if "start" in cfg:
        return "sdedit"
    if runtime.is_controlnet(cfg.get("sd_version", "")):
        return "controlnet"
    raise ValueError(
        f"--then_edit: cannot infer the editor family from {config_path!r} "
        "(expected a pnp_attn_t, start, or ControlNet sd_version key)"
    )


def run_then_edit(config_path: str, family: str):
    """``--then_edit``: the stage-2 editor of ``family`` on ``config_path``,
    in this process, after preprocess (``runtime.load_stack`` holds the
    stack, so an editor of the same sd_version, dtype and init reuses its
    weights). Returns the editor's decoded frames."""
    if family == "pnp":
        from tokenflow_torch.cli import run_pnp as editor
    elif family == "sdedit":
        from tokenflow_torch.cli import run_sdedit as editor
    else:
        from tokenflow_torch.cli import run_controlnet as editor
    print(f"[tokenflow-torch] --then_edit: running {editor.__name__}")
    return editor.main(["--config_path", config_path])


def run(opt) -> dict:
    """Preprocess with the parsed options ``opt``; returns the save path and
    the phases' seconds (rank 0 adds the reconstruction's PSNR)."""
    utils.seed_everything(1)  # reference seeds 1 (preprocess.py:303)
    group = mesh.frames_group_from_env(opt.data_parallel, opt.device)
    device = group.device if group else utils.resolve_device(opt.device)
    if group is not None:
        mesh.check_divisible(opt.n_frames, group.world)
    writer = mesh.is_writer(group)

    video_stem = Path(opt.data_path).stem
    save_path = latents_io.save_path_for(
        opt.save_dir, opt.sd_version, video_stem, opt.steps, opt.n_frames
    )
    if writer:
        os.makedirs(os.path.join(save_path, "latents"), exist_ok=True)
        latents_io.write_inversion_prompt(
            opt.save_dir, save_path, video_stem, opt.inversion_prompt
        )
    stack = runtime.load_stack(
        opt.sd_version, device=device, model_dir=opt.model_dir,
        dtype=DTYPES[opt.dtype], init=opt.init,
        group_norm_kernel=opt.group_norm_kernel,
    )
    frames = video_io.load_frames(opt.data_path, opt.n_frames, resize_square=opt.H)
    lat = stack.encode_frames(frames, group=group)  # (F, h, w, 4) fp32, the rank's
    # cond only; rank 0's (HashTokenizer hashes words per process)
    cond = mesh.broadcast(group, stack.encode_prompt(opt.inversion_prompt, "")[1:2])
    controlnet = canny = depth = None
    if runtime.is_controlnet(opt.sd_version):
        controlnet, canny = controlnet_utils.build_controlnet(
            stack, frames, opt.controlnet_dir, opt.init
        )
        canny = canny if group is None else group.local(canny)
    t_depth = None
    if runtime.is_depth(opt.sd_version):
        with utils.Timer() as t_depth:
            depth = cli_common.rank0_first(group, lambda: load_depth_maps(
                opt.data_path, opt.n_frames, lat.shape[1:3],
                model_dir=opt.depth_model_dir, device=device))
            depth = depth if group is None else group.local(depth)
            utils.synchronize(device)
        print(f"[tokenflow-torch] depth maps: {t_depth.seconds:.1f}s")

    sched = ddim.make_schedule(opt.steps)
    frame_chunk = opt.batch_size if opt.batch_size < lat.shape[0] else None
    eps_fn = build_eps_fn(stack, cond, frame_chunk, controlnet, canny, depth)

    # segments: checkpoint boundaries only (one segment without a checkpoint)
    seg_len = utils.plan_seg_len(
        opt.steps, opt.steps_per_dispatch if opt.checkpoint_inversion else 0
    )
    slices = utils.segment_slices(opt.steps, seg_len)
    if len(slices) > 1:
        print(f"[tokenflow-torch] inversion in {len(slices)} segments of <= {seg_len} steps")
    ck = cli_common.SegmentCheckpointer(
        os.path.join(save_path, "inversion_checkpoint.npz"),
        _inversion_fingerprint(opt, slices,
                               cli_common.stack_identity(stack, opt.inversion_prompt)),
        opt.checkpoint_inversion,
        every=opt.checkpoint_every,
        group=group,
        frame_axes=(0, 1),  # x and the trajectory (n_save, F, ...)
    )
    utils.synchronize(device)
    mesh.barrier(group)
    with utils.Timer() as t_inv:
        x_T, traj, save_ts = mesh.sharded_inversion(
            eps_fn, lat, sched, opt.save_steps, group, segments=slices, checkpoint=ck)
        utils.synchronize(device)
        mesh.barrier(group)
    print(f"[tokenflow-torch] inversion ({opt.steps} steps): {t_inv.seconds:.1f}s")

    traj_all = mesh.gather_to_rank0(group, traj, axis=1)
    x_T_all = mesh.gather_to_rank0(group, x_T)
    if writer:
        latents_io.save_trajectory(
            save_path,
            traj_all.float().cpu().numpy(),
            save_ts,
            x_T_all.float().cpu().numpy(),
            int(sched.timesteps[0]),
        )
        if opt.export_pt:
            latents_io.export_reference_layout(save_path)
    result = {"save_path": save_path, "inversion_seconds": t_inv.seconds}
    if t_depth is not None:
        result["depth_seconds"] = t_depth.seconds
    if opt.skip_reconstruction:
        return result

    with utils.Timer() as t_rec:
        lat_rec = inversion.ddim_reconstruction(eps_fn, x_T, sched)
        utils.synchronize(device)
        mesh.barrier(group)
    print(f"[tokenflow-torch] reconstruction: {t_rec.seconds:.1f}s")
    result["reconstruction_seconds"] = t_rec.seconds
    rgb = stack.decode_latents(lat_rec, group=group)
    if rgb is None:  # rank 0 writes
        return result
    rgb = rgb.cpu().numpy()
    video_io.save_frames(rgb, os.path.join(save_path, "frames"))
    video_io.save_video(rgb, os.path.join(save_path, "inverted.mp4"), fps=10)
    rec_psnr = utils.psnr(rgb, frames)
    print(f"[tokenflow-torch] reconstruction PSNR vs input: {rec_psnr:.2f} dB")
    result["reconstruction_psnr"] = rec_psnr
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_path", type=str, default="data/woman-running.mp4")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--save_dir", type=str, default="latents")
    p.add_argument("--sd_version", type=str, default="2.1", choices=runtime.SD_VERSIONS)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--save_steps", type=int, default=50)
    p.add_argument("--n_frames", type=int, default=40)
    p.add_argument("--inversion_prompt", type=str, default="a woman running")
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument(
        "--controlnet_dir", type=str, default=None,
        help="diffusers-layout ControlNet directory (sd_version ControlNet)",
    )
    p.add_argument(
        "--depth_model_dir", type=str, default=None,
        help="Intel/dpt-large checkpoint (directory or weight file) for the "
             "depth maps of sd_version depth, when data_path has no depth/*.npy",
    )
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--init", choices=["auto", "pretrained", "random"], default="auto")
    p.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    p.add_argument(
        "--data_parallel", type=str, default="auto",
        help="shard the frames over a launcher's processes (torchrun): 'auto' = "
        "its world size (1 without one), N = exactly N processes, 'off' = one",
    )
    p.add_argument(
        "--export_pt", action="store_true",
        help="also write reference-compatible noisy_latents_{t}.pt files",
    )
    p.add_argument(
        "--skip_reconstruction", action="store_true",
        help="skip the DDIM reconstruction sanity pass",
    )
    p.add_argument(
        "--group_norm_kernel", action="store_true",
        help="run every UNet and VAE GroupNorm through the GroupNorm kernel",
    )
    p.add_argument(
        "--steps_per_dispatch", type=int, default=0,
        help="with --checkpoint_inversion, the inversion's segment length in "
        "steps: where a checkpoint can fall (the same maths). 0 = one segment",
    )
    p.add_argument(
        "--checkpoint_inversion", action="store_true",
        help="write the inversion carry to "
        "<save_path>/inversion_checkpoint.npz at dispatch boundaries and "
        "resume a matching interrupted run from it (exact: segments are "
        "scan splits). Sized by the save grid; forces a host sync per "
        "dispatch",
    )
    p.add_argument(
        "--checkpoint_every", type=int, default=1,
        help="with --checkpoint_inversion, persist the carry only every "
        "Nth dispatch boundary (each write is a host sync + ~0.9 GB npz "
        "at 120-frame 768p scale); resume restarts from the last saved "
        "boundary, bitwise",
    )
    p.add_argument(
        "--then_edit", type=str, default=None,
        help="path to a stage-2 editor YAML (PnP, SDEdit or ControlNet, "
        "inferred from its keys before the inversion): run that editor in "
        "this process after preprocess, on the same model stack",
    )
    return p


def main(argv=None) -> dict:
    opt = build_parser().parse_args(argv)
    family = None
    if opt.then_edit:  # a wrong stage-2 config fails now, not after the inversion
        family = infer_editor_family(cli_common.load_config(opt.then_edit), opt.then_edit)
    if opt.data_path.endswith((".mp4", ".mov", ".avi")):
        group = mesh.frames_group_from_env(opt.data_parallel, opt.device)
        if mesh.is_writer(group):
            video_io.video_to_frames(opt.data_path, img_size=(opt.W, opt.H))
        mesh.barrier(group)
        opt.data_path = os.path.join("data", Path(opt.data_path).stem)
    result = run(opt)
    if family is not None:
        run_then_edit(opt.then_edit, family)
    return result


if __name__ == "__main__":
    main()

"""TokenFlow-SDEdit editor CLI (stage 2) of the PyTorch port: a truncated
denoising schedule, keyframe extended attention and NN token propagation,
with no PnP injection.

    python -m tokenflow_torch.cli.run_sdedit --config_path configs/config_sdedit.yaml

Same YAML keys, schedule truncation (``ddim.truncate_schedule``, the
reference's operator precedence), ``use_ddim_noise`` switch, output-path
encoding and output tree as ``tokenflow_tpu/cli/run_sdedit.py``.
``--vanilla`` runs the per-frame SDEdit baseline instead (no TokenFlow),
writing ``img_ode_vanilla_sde/`` and ``vanilla_sde*.mp4``. ``device`` is
``cuda`` (default) or ``cpu``; ``group_norm_kernel`` picks the GroupNorm
path (``cli/common.py``). ``checkpoint_edit`` checkpoints both loops, and
``data_parallel`` shards the frames of both over a launcher's processes
(``cli/common.py``; the vanilla loop is frame-parallel, each rank samples
its block in chunks of at most ``batch_size`` frames).
"""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tokenflow_torch import utils
from tokenflow_torch.cli import common
from tokenflow_torch.diffusion import ddim
from tokenflow_torch.editing import pipeline
from tokenflow_torch.io import video as video_io
from tokenflow_torch.profiling import PhaseMetrics


def start_noise(config: dict, eps: torch.Tensor) -> torch.Tensor:
    """The noise SDEdit starts from: the inversion's implied noise
    (``use_ddim_noise``, the default), or one fresh noise map shared by
    every frame, drawn from a generator seeded with ``seed`` (the intent of
    the reference's non-default branch, run_tokenflow_sdedit.py:198; it
    cannot equal the JAX PRNG draw)."""
    if config.get("use_ddim_noise", True):
        return eps
    gen = torch.Generator().manual_seed(config["seed"])
    n1 = torch.randn(eps[:1].shape, generator=gen, dtype=torch.float32)
    return n1.to(eps.device).expand(eps.shape)


def edit_video(config: dict, vanilla: bool = False) -> Optional[np.ndarray]:
    """The SDEdit edit of ``config`` (``vanilla``: the per-frame baseline);
    returns the decoded frames (None on the ranks other than 0 of a frames
    group)."""
    common.refuse_depth_for_sdedit(config["sd_version"])
    generator = utils.seed_everything(config["seed"])
    data = common.setup_editor(config, use_steps_dir=False)
    stack, device = data.stack, data.stack.device

    sched = ddim.truncate_schedule(
        ddim.make_schedule(config["n_timesteps"]), config["start"]
    )
    schedule = pipeline.make_edit_schedule(sched, data.trajectory.save_ts)
    alpha_0 = sched.alphas_cumprod[sched.timesteps[0]]
    x_init = ddim.add_noise(
        data.latents, start_noise(config, data.eps), alpha_0
    ).to(stack.dtype)
    n_steps = len(schedule.timesteps)
    metrics = PhaseMetrics()
    out = config["output_path"]

    if vanilla:
        # the rank's frames in chunks of at most batch_size that divide them
        chunk = math.gcd(config["batch_size"], x_init.shape[0])

        def step_fn(x, sched_seg, _piv):
            return pipeline.vanilla_sample_loop(
                stack.unet_apply, x, data.embeds3[1:], sched_seg,
                guidance_scale=config["guidance_scale"], frame_chunk=chunk,
                added_cond=None if data.added_cond is None else {
                    k: v[1:] for k, v in data.added_cond.items()},
            )

        with common.device_phase(metrics, "edit_loop", device, data.group), \
                utils.Timer() as t_edit:
            latents_out = common.run_segmented_edit(
                config, common.schedule_segments(config, schedule), step_fn, x_init,
                data.identity,
            )
        seconds = t_edit.seconds
        with metrics.phase("decode_and_save"):
            with common.device_phase(metrics, "decode", device, data.group):
                decoded = stack.decode_latents(latents_out, batch=common.VAE_BATCH_SIZE,
                                               group=data.group)
            if decoded is not None:
                decoded = decoded.cpu().numpy()
                video_io.save_frames(decoded, os.path.join(out, "img_ode_vanilla_sde"))
                for fps, name in (
                    (10, "vanilla_sde.mp4"), (20, "vanilla_sde_fps20.mp4"),
                    (30, "vanilla_sde_fps30.mp4"),
                ):
                    video_io.save_video(decoded, os.path.join(out, name), fps=fps)
    else:
        pivots = common.resolve_pivots(config, generator, n_steps, config["n_frames"],
                                       data.group)
        latents_out, seconds = common.run_edit_loop(data, schedule, x_init, pivots, metrics,
                                                    pnp=False)
        metrics.add("pivot_indices", pivots.tolist())
        with metrics.phase("decode_and_save"):
            decoded = common.save_outputs(data, latents_out, "SDEdit", metrics)
    fps = config["n_frames"] / seconds
    print(
        f"[tokenflow-torch] {'vanilla ' if vanilla else ''}SDEdit loop ({n_steps} "
        f"steps, {config['n_frames']} frames) on {device}: {seconds:.1f}s "
        f"({fps:.2f} edited frames/s)"
    )
    metrics.add("device", str(device))
    metrics.add("vanilla", vanilla)
    metrics.add("edited_frames_per_sec", fps)
    metrics.add("n_steps", n_steps)
    metrics.add("video_encoder", video_io.LAST_ENCODER)
    common.finish_metrics(data, metrics, "metrics_vanilla.json" if vanilla else "metrics.json")
    print("Done!")
    return decoded


def resolve_output_path(config: dict) -> dict:
    """Reference output-dir encoding (run_tokenflow_sdedit.py:274-278)."""
    config["output_path"] = os.path.join(
        config["output_path"] + "_sdedit",
        Path(config["data_path"]).stem,
        config["prompt"][:240],
        f"batch_size_{str(config['batch_size'])}",
        str(config["n_timesteps"]) + f"start_{config['start']}",
    )
    return config


def main(argv=None) -> Optional[np.ndarray]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", type=str, default="configs/config_sdedit.yaml")
    parser.add_argument(
        "--vanilla", action="store_true",
        help="run the per-frame SDEdit baseline (no TokenFlow)",
    )
    opt = parser.parse_args(argv)
    config = common.load_config(opt.config_path)
    common.validate_config(config, "sdedit")
    config = resolve_output_path(config)
    if not os.path.exists(config["data_path"]):
        raise FileNotFoundError(f"data path {config['data_path']} does not exist")
    common.start_output(config)
    print(config)
    return edit_video(config, vanilla=opt.vanilla)


if __name__ == "__main__":
    main()

"""TokenFlow-ControlNet editor CLI (stage 2) of the PyTorch port: keyframe
extended attention and NN token propagation with canny ControlNet
conditioning on every UNet call (all three streams), no PnP injection.

    python -m tokenflow_torch.cli.run_controlnet --config_path configs/config_controlnet.yaml

Same YAML keys, output-path encoding (``<output_path>_controlnet/...``),
config.yaml dump and output tree (mp4s tagged ``ControlNet``) as
``tokenflow_tpu/cli/run_controlnet.py``; the latents come from
``preprocess --sd_version ControlNet``. ``controlnet_dir`` names a local
diffusers-layout ControlNet (else random weights, whose zero projections
add nothing). ``device`` is ``cuda`` (default) or ``cpu``; phase times go
to ``metrics.json`` as ``run_pnp`` writes them. ``data_parallel`` shards
the frames over a launcher's processes (``cli/common.py``).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional

import numpy as np

from tokenflow_torch import utils
from tokenflow_torch.cli import common, controlnet_utils
from tokenflow_torch.diffusion import ddim
from tokenflow_torch.editing import pipeline
from tokenflow_torch.io import video as video_io
from tokenflow_torch.profiling import PhaseMetrics


def edit_video(config: dict) -> Optional[np.ndarray]:
    """The ControlNet edit of ``config``; returns the decoded frames (None
    on the ranks other than 0 of a frames group)."""
    generator = utils.seed_everything(config["seed"])
    data = common.setup_editor(config)
    stack, device = data.stack, data.stack.device
    metrics = PhaseMetrics()
    with common.device_phase(metrics, "vae_recon", device, data.group):
        common.save_vae_recon(data)
    controlnet, canny = controlnet_utils.build_controlnet(
        stack, data.frames, config.get("controlnet_dir"), config.get("init", "auto")
    )

    sched = ddim.make_schedule(config["n_timesteps"])
    schedule = pipeline.make_edit_schedule(sched, data.trajectory.save_ts)
    alpha_0 = sched.alphas_cumprod[sched.timesteps[0]]
    x_init = ddim.add_noise(data.latents, data.eps, alpha_0)
    pivots = common.resolve_pivots(
        config, generator, len(schedule.timesteps), config["n_frames"], data.group
    )

    latents_out, seconds = common.run_edit_loop(
        data, schedule, x_init, pivots, metrics, pnp=False,
        controlnet_fn=controlnet, cond_image=data.local(canny),
    )
    n_steps = len(schedule.timesteps)
    fps = config["n_frames"] / seconds
    print(
        f"[tokenflow-torch] ControlNet edit loop ({n_steps} steps, "
        f"{config['n_frames']} frames) on {device}: {seconds:.1f}s "
        f"({fps:.2f} edited frames/s)"
    )
    with metrics.phase("decode_and_save"):
        decoded = common.save_outputs(data, latents_out, "ControlNet", metrics)
    metrics.add("device", str(device))
    metrics.add("edited_frames_per_sec", fps)
    metrics.add("n_steps", n_steps)
    metrics.add("pivot_indices", pivots.tolist())
    metrics.add("video_encoder", video_io.LAST_ENCODER)
    common.finish_metrics(data, metrics)
    print("Done!")
    return decoded


def resolve_output_path(config: dict) -> dict:
    """The JAX editor's output-dir encoding (tokenflow_tpu/cli/run_controlnet.py)."""
    config["output_path"] = os.path.join(
        config["output_path"] + "_controlnet",
        Path(config["data_path"]).stem,
        config["prompt"][:240],
        f"batch_size_{str(config['batch_size'])}",
        str(config["n_timesteps"]),
    )
    return config


def main(argv=None) -> Optional[np.ndarray]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config_path", type=str, default="configs/config_controlnet.yaml"
    )
    opt = parser.parse_args(argv)
    config = common.load_config(opt.config_path)
    common.validate_config(config, "controlnet")
    config = resolve_output_path(config)
    if not os.path.exists(config["data_path"]):
        raise FileNotFoundError(f"data path {config['data_path']} does not exist")
    common.start_output(config)
    print(config)
    return edit_video(config)


if __name__ == "__main__":
    main()

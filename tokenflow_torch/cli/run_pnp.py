"""TokenFlow-PnP editor CLI (stage 2) of the PyTorch port: keyframe
extended attention, PnP feature/attention injection and NN token
propagation.

    python -m tokenflow_torch.cli.run_pnp --config_path configs/config_pnp.yaml

Same YAML keys, output-path encoding, config.yaml dump and output tree as
``tokenflow_tpu/cli/run_pnp.py``. ``device`` is ``cuda`` (default) or
``cpu``. A depth model (``sd_version: depth``) edits with each frame's
depth map as the UNet's fifth channel (``depth_model_dir``: see
``cli/common.py``).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from tokenflow_torch import utils
from tokenflow_torch.cli import common
from tokenflow_torch.diffusion import ddim
from tokenflow_torch.editing import pipeline
from tokenflow_torch.io import video as video_io
from tokenflow_torch.profiling import PhaseMetrics


def edit_video(config: dict) -> np.ndarray:
    generator = utils.seed_everything(config["seed"])
    data = common.setup_editor(config)
    stack, device = data.stack, data.stack.device

    sched = ddim.make_schedule(config["n_timesteps"])
    schedule = pipeline.make_edit_schedule(
        sched, data.trajectory.save_ts,
        pnp_attn_t=config["pnp_attn_t"], pnp_f_t=config["pnp_f_t"],
    )
    alpha_0 = sched.alphas_cumprod[sched.timesteps[0]]
    x_init = ddim.add_noise(data.latents, data.eps, alpha_0)
    pivots = common.resolve_pivots(
        config, generator, len(schedule.timesteps), config["n_frames"]
    )

    metrics = PhaseMetrics()
    with common.device_phase(metrics, "vae_recon", device):
        common.save_vae_recon(data)
    latents_out, seconds = common.run_edit_loop(data, schedule, x_init, pivots, metrics,
                                                pnp=True, depth=common.load_depth(data))
    n_steps = len(schedule.timesteps)
    fps = config["n_frames"] / seconds
    print(
        f"[tokenflow-torch] edit loop ({n_steps} steps, {config['n_frames']} "
        f"frames) on {device}: {seconds:.1f}s ({fps:.2f} edited frames/s)"
    )
    with metrics.phase("decode_and_save"):
        decoded = common.save_outputs(data, latents_out, "PnP", metrics)
    metrics.add("device", str(device))
    metrics.add("edited_frames_per_sec", fps)
    metrics.add("n_steps", n_steps)
    metrics.add("pivot_indices", pivots.tolist())
    metrics.add("video_encoder", video_io.LAST_ENCODER)
    metrics.dump(os.path.join(config["output_path"], "metrics.json"))
    print("Done!")
    return decoded


def resolve_output_path(config: dict) -> dict:
    """Reference output-dir encoding (run_tokenflow_pnp.py:289-295)."""
    config["output_path"] = os.path.join(
        config["output_path"] + f"_pnp_SD_{config['sd_version']}",
        Path(config["data_path"]).stem,
        config["prompt"][:240],
        f"attn_{config['pnp_attn_t']}_f_{config['pnp_f_t']}",
        f"batch_size_{str(config['batch_size'])}",
        str(config["n_timesteps"]),
    )
    return config


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", type=str, default="configs/config_pnp.yaml")
    opt = parser.parse_args(argv)
    config = common.load_config(opt.config_path)
    common.validate_config(config, "pnp")
    config = resolve_output_path(config)
    os.makedirs(config["output_path"], exist_ok=True)
    if not os.path.exists(config["data_path"]):
        raise FileNotFoundError(f"data path {config['data_path']} does not exist")
    common.dump_config(config)
    print(config)
    return edit_video(config)


if __name__ == "__main__":
    main()

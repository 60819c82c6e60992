"""High-level Python API of the port, the counterpart of
``tokenflow_tpu/api.py`` (the CLIs wrap these; importable for notebooks and
programmatic use).

    from tokenflow_torch import api

    api.invert(data_path="data/wolf", inversion_prompt="a wolf", ...)
    api.edit_pnp(config)      # dict with the reference's YAML keys
    api.edit_sdedit(config)
    api.edit_controlnet(config)

Under a launcher (torchrun) with ``data_parallel`` these run sharded as
the CLIs do: rank 0 writes the outputs and returns the frames, the other
ranks return None.
"""

from __future__ import annotations

from typing import Any


def invert(**kwargs) -> dict:
    """DDIM-invert a frame directory. kwargs mirror the preprocess CLI's
    flags (data_path, inversion_prompt, steps, save_steps, n_frames,
    batch_size, sd_version, save_dir, model_dir, dtype, init, device,
    export_pt, H, W, data_parallel, ...); an unknown one raises TypeError.
    Returns {save_path, inversion_seconds, reconstruction_seconds,
    reconstruction_psnr}."""
    from tokenflow_torch.cli.preprocess import build_parser, run

    opt = build_parser().parse_args([])
    for k, v in kwargs.items():
        if not hasattr(opt, k):
            raise TypeError(f"unknown preprocess option {k!r}")
        setattr(opt, k, v)
    return run(opt)


def _edit(config: dict[str, Any], runner, mode: str):
    from tokenflow_torch.cli import common

    config = dict(config)
    common.validate_config(config, mode)
    common.start_output(config)
    return runner(config)


def edit_pnp(config: dict[str, Any]):
    """TokenFlow-PnP edit. config uses the reference YAML keys; unlike the
    CLI, output_path is used as-is (no hyperparameter path encoding)."""
    from tokenflow_torch.cli.run_pnp import edit_video

    return _edit(config, edit_video, "pnp")


def edit_sdedit(config: dict[str, Any], vanilla: bool = False):
    """TokenFlow-SDEdit edit (``vanilla``: the per-frame baseline), output
    under output_path as-is."""
    from tokenflow_torch.cli.run_sdedit import edit_video

    return _edit(config, lambda c: edit_video(c, vanilla=vanilla), "sdedit")


def edit_controlnet(config: dict[str, Any]):
    """TokenFlow-ControlNet edit, output under output_path as-is."""
    from tokenflow_torch.cli.run_controlnet import edit_video

    return _edit(config, edit_video, "controlnet")

"""Exact against approximate (``prop_approx``) propagation through the
port's CLIs, with the same pinned pivots on both sides, scored by
``cli/compare_outputs.py``: the port's twin of ``scripts/prop_approx_ab.py``.

    python -m tokenflow_torch.cli.prop_approx_ab WORKDIR [--device cuda|cpu]
        [--sd_version 2.1] [--frames 40] [--hw 512] [--steps 20]
        [--save_steps 10] [--timesteps 10] [--clip_ckpt DIR --prompt ...]

1. write a gently moving synthetic clip to WORKDIR/data/clip and invert it
   (``preprocess``, random weights unless ``--init``);
2. a PnP edit with exact propagation, which records its drawn pivots in
   ``pivots.json``;
3. a PnP edit with ``prop_approx: true``, its pivots pinned to step 2's
   table through ``pivot_indices``, so that the two outputs differ by the
   approximation only;
4. the report of the exact ``img_ode/`` against the approximate one
   (PSNR, and CLIP metrics with ``--clip_ckpt``), printed and written to
   WORKDIR/approx_ab_report.json.

Everything runs in this process on ``--device`` (default ``cuda``; ``cpu``
only when asked, e.g. ``--device cpu --sd_version tiny --frames 4 --hw 64
--steps 8 --save_steps 4 --timesteps 4 --window 2``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import yaml
from PIL import Image

from tokenflow_torch.cli import compare_outputs, preprocess, run_pnp


def make_clip(data_dir: str, n_frames: int, hw: int) -> None:
    """``n_frames`` frames of one seeded random image shifted 2 px a frame."""
    os.makedirs(data_dir, exist_ok=True)
    base = np.random.default_rng(0).integers(40, 210, (hw, hw, 3), dtype=np.uint8)
    for i in range(n_frames):
        Image.fromarray(np.roll(base, shift=2 * i, axis=1)).save(
            os.path.join(data_dir, f"{i:05d}.png")
        )


def edit(work: str, opt, prop_approx: bool, pivot_indices=None) -> tuple[str, list]:
    """One PnP edit through ``run_pnp.main`` -> (its img_ode dir, its pivot
    table)."""
    name = "approx" if prop_approx else "exact"
    cfg = {
        "seed": 1, "device": opt.device, "init": opt.init, "dtype": opt.dtype,
        "output_path": os.path.join(work, f"results_{name}"),
        "data_path": os.path.join(work, "data", "clip"),
        "latents_path": os.path.join(work, "latents"),
        "n_inversion_steps": opt.steps, "n_frames": opt.frames,
        "sd_version": opt.sd_version, "guidance_scale": 7.5,
        "n_timesteps": opt.timesteps, "prompt": opt.prompt,
        "negative_prompt": "", "batch_size": opt.window,
        "pnp_attn_t": 0.5, "pnp_f_t": 0.8, "image_size": opt.hw,
        "prop_approx": prop_approx,
    }
    if pivot_indices is not None:
        cfg["pivot_indices"] = pivot_indices
    path = os.path.join(work, f"config_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run_pnp.main(["--config_path", path])
    out = run_pnp.resolve_output_path(dict(cfg))["output_path"]
    with open(os.path.join(out, "pivots.json")) as f:
        pivots = json.load(f)["pivot_indices"]
    return os.path.join(out, "img_ode"), pivots


def run(opt) -> dict:
    work = os.path.abspath(opt.workdir)
    make_clip(os.path.join(work, "data", "clip"), opt.frames, opt.hw)
    preprocess.main([
        "--data_path", os.path.join(work, "data", "clip"), "--H", str(opt.hw),
        "--W", str(opt.hw), "--save_dir", os.path.join(work, "latents"),
        "--sd_version", opt.sd_version, "--init", opt.init, "--dtype", opt.dtype,
        "--steps", str(opt.steps), "--save_steps", str(opt.save_steps),
        "--n_frames", str(opt.frames), "--batch_size", str(opt.frames),
        "--inversion_prompt", "a test clip", "--device", opt.device,
        "--skip_reconstruction",
    ])
    dir_exact, pivots = edit(work, opt, False)
    dir_approx, pivots_b = edit(work, opt, True, pivot_indices=pivots)
    if pivots_b != pivots:
        raise RuntimeError("pivot pinning failed: the approximate edit drew other pivots")
    report = compare_outputs.compare(dir_exact, dir_approx, opt.clip_ckpt, opt.prompt,
                                     opt.device)
    with open(os.path.join(work, "approx_ab_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print("A/B (exact vs approx, pinned pivots):", json.dumps(report))
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("workdir")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--sd_version", default="2.1")
    p.add_argument("--init", choices=["auto", "pretrained", "random"], default="random")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--window", type=int, default=8, help="keyframe window (batch_size)")
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--steps", type=int, default=20, help="inversion steps")
    p.add_argument("--save_steps", type=int, default=10)
    p.add_argument("--timesteps", type=int, default=10, help="edit steps")
    p.add_argument("--prompt", default="a stained glass mosaic")
    p.add_argument("--clip_ckpt", default=None,
                   help="HF CLIPModel checkpoint (dir or file) for CLIP metrics")
    return p


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

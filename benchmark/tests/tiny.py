"""A copy of the benchmark with tiny cells added, for the tests: a
two-level UNet (and ControlNet) in the published layouts' shape, four
frames of 8 x 8 latents, window 2, on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_UNET = {
    "act_fn": "silu", "attention_head_dim": [2, 4], "block_out_channels": [32, 64],
    "cross_attention_dim": 32, "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4, "layers_per_block": 1,
    "norm_eps": 1e-05, "norm_num_groups": 32, "out_channels": 4,
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "use_linear_projection": True,
}
TINY_CONTROLNET = dict(TINY_UNET, conditioning_embedding_out_channels=[16, 32, 96, 256])
TINY_EDIT = {"stage": "edit", "frames": 4, "resolution": 64, "motion_px": 2, "timesteps": 4,
             "inversion_steps": 8, "save_steps": 4, "window": 2, "guidance_scale": 7.5,
             "compared_later_steps": 1}
TINY_TRAFFIC = {
    "tiny_pnp": dict(TINY_EDIT, editor="pnp", pnp_attn_t=0.5, pnp_f_t=0.8),
    "tiny_controlnet": dict(TINY_EDIT, editor="controlnet"),
    "tiny_sdedit": dict(TINY_EDIT, editor="sdedit", start=0.9),
    "tiny_invert": {"stage": "invert", "frames": 4, "resolution": 64, "motion_px": 2,
                    "timesteps": 8, "save_steps": 4, "compared_later_steps": 1},
}
TINY_CELLS = {  # cell -> (config, traffic)
    "tiny_pnp_edit": ("tiny", "tiny_pnp"),
    "tiny_cn_edit": ("tiny_cn", "tiny_controlnet"),
    "tiny_sdedit_edit": ("tiny", "tiny_sdedit"),
    "tiny_invert": ("tiny", "tiny_invert"),
}


def fixed_window(steps: int):
    """A stand-in for ``harness.window`` that runs ``steps`` steps whatever
    they take, so which steps are compared does not depend on the machine's
    speed."""
    def window(stage, seconds, traced, cuda):
        for k in range(steps):
            stage.step(k, check=not traced)
        return steps, 1.0

    return window


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def copy_with_tiny_cells(dest: Path, limits, cells: dict = TINY_CELLS,
                         configs: dict | None = None, traffic: dict | None = None) -> Path:
    """``dest``/BENCHMARK.json and ``dest``/benchmark: the benchmark with
    the tiny configurations (and ``configs``: name -> the keys a configuration
    sets over sd21's), mixes (and ``traffic``: name -> mix) and ``cells``
    added, each with the output limits ``limits(cell)``; returns the copy's
    benchmark directory."""
    mixes = {**TINY_TRAFFIC, **(traffic or {})}
    root = dest / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "sd21.json").read_text())
    configs = {"tiny": {"unet": TINY_UNET},
               "tiny_cn": {"unet": TINY_UNET, "controlnet": TINY_CONTROLNET}, **(configs or {})}
    for name, keys in configs.items():
        _dump(root / "configs" / f"{name}.json", dict(config, name=name, **keys))
    for name, mix in mixes.items():
        _dump(root / "traffic" / f"{name}.json", mix)
    for cell, (cfg, mix) in cells.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix,
                                   "chips": 1, "why": "test"})
        _dump(root / "limits" / f"{cell}.json", {"limits": limits(cell)})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            stage = "invert" if "invert" in m.get("moves", m["name"]) else "edit"
            m["workloads"] += [c for c, (_, t) in cells.items()
                               if mixes[t]["stage"] == stage]
    _dump(dest / "BENCHMARK.json", bench)
    return root

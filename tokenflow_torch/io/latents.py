"""Latent-trajectory checkpoint store.

The port's own copy of ``tokenflow_tpu/io/latents.py``: the same
functions and the same ``trajectory.npz`` format, so an inversion written
by either package is read by the other, and the port imports nothing of
the JAX package.

The reference couples its two CLI stages through a directory of per-timestep
``noisy_latents_{t}.pt`` tensors (preprocess.py:227-229 produced;
run_tokenflow_pnp.py:114-125 + tokenflow_utils.py:43-47 consumed, reloading
the same full tensor from disk 6x per denoising step). Here the trajectory
is ONE stacked array written once:

    {save_path}/latents/trajectory.npz
        traj:     (n_save, F, h, w, 4) float16, NHWC, ascending timesteps
        save_ts:  (n_save,) int32
        final:    (F, h, w, 4) float16  — the endpoint (t_max, reference's
                  trailing noisy_latents_999.pt)

Directory layout parity with the reference is preserved
(``latents/sd_{ver}/{video}/steps_{N}/nframes_{F}/latents/``), and loading
transparently falls back to a directory of reference-produced ``.pt`` files
(via torch CPU) so artifacts are interoperable in both directions
(``export_reference_layout`` writes them).
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import yaml


@dataclass
class LatentTrajectory:
    traj: np.ndarray  # (n_save, F, h, w, 4) NHWC
    save_ts: np.ndarray  # (n_save,) ascending
    final: np.ndarray  # (F, h, w, 4)
    final_t: int

    def at_timestep(self, t: int) -> np.ndarray:
        idx = np.nonzero(self.save_ts == t)[0]
        if len(idx) == 0:
            raise KeyError(f"timestep {t} not in trajectory")
        return self.traj[int(idx[0])]


def save_path_for(
    save_dir: str, sd_version: str, video_stem: str, steps: int, n_frames: int
) -> str:
    """Reference layout (preprocess.py:305-309)."""
    return os.path.join(
        save_dir,
        f"sd_{sd_version}",
        video_stem,
        f"steps_{steps}",
        f"nframes_{n_frames}",
    )


def save_trajectory(
    save_path: str,
    traj: np.ndarray,
    save_ts: np.ndarray,
    final: np.ndarray,
    final_t: int,
) -> str:
    lat_dir = os.path.join(save_path, "latents")
    os.makedirs(lat_dir, exist_ok=True)
    out = os.path.join(lat_dir, "trajectory.npz")
    np.savez(
        out,
        traj=traj.astype(np.float16),
        save_ts=np.asarray(save_ts, np.int32),
        final=final.astype(np.float16),
        final_t=np.asarray(final_t, np.int32),
    )
    return out


def export_reference_layout(save_path: str) -> None:
    """Additionally write reference-compatible noisy_latents_{t}.pt files
    (NCHW fp16 torch tensors) so reference tooling can consume our
    inversions."""
    import torch

    lat_dir = os.path.join(save_path, "latents")
    store = load_trajectory(save_path)
    for i, t in enumerate(store.save_ts):
        x = torch.from_numpy(
            np.ascontiguousarray(
                store.traj[i].transpose(0, 3, 1, 2).astype(np.float16)
            )
        )
        torch.save(x, os.path.join(lat_dir, f"noisy_latents_{int(t)}.pt"))
    x = torch.from_numpy(
        np.ascontiguousarray(
            store.final.transpose(0, 3, 1, 2).astype(np.float16)
        )
    )
    torch.save(
        x, os.path.join(lat_dir, f"noisy_latents_{store.final_t}.pt")
    )


def load_trajectory(save_path: str) -> LatentTrajectory:
    lat_dir = os.path.join(save_path, "latents")
    npz = os.path.join(lat_dir, "trajectory.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        return LatentTrajectory(
            traj=z["traj"].astype(np.float32),
            save_ts=z["save_ts"],
            final=z["final"].astype(np.float32),
            final_t=int(z["final_t"]),
        )
    return _load_reference_pt_dir(lat_dir)


def _load_reference_pt_dir(lat_dir: str) -> LatentTrajectory:
    """Fallback: a directory of reference-produced noisy_latents_{t}.pt."""
    import torch

    files = glob.glob(os.path.join(lat_dir, "noisy_latents_*.pt"))
    if not files:
        raise FileNotFoundError(
            f"no trajectory.npz or noisy_latents_*.pt in {lat_dir}"
        )
    by_t = {}
    for f in files:
        m = re.search(r"noisy_latents_(\d+)\.pt$", f)
        if m:
            by_t[int(m.group(1))] = f

    def load_t(t):
        x = torch.load(by_t[t], map_location="cpu", weights_only=True)
        return x.float().numpy().transpose(0, 2, 3, 1)  # NCHW -> NHWC

    ts = sorted(by_t)
    final_t = ts[-1]
    # Heuristic matching the reference's layout: the max timestep is the
    # inversion endpoint; the rest are the save grid.
    grid_ts = ts[:-1] if len(ts) > 1 else ts
    traj = np.stack([load_t(t) for t in grid_ts])
    return LatentTrajectory(
        traj=traj,
        save_ts=np.asarray(grid_ts, np.int32),
        final=load_t(final_t),
        final_t=final_t,
    )


def find_latents_path(
    latents_dir: str,
    sd_version: str,
    video_stem: str,
    n_inversion_steps: int | None,
    requested_frames: int,
    batch_size: int,
) -> tuple[str, int]:
    """Resolve the inversion artifact dir and the usable frame count.

    Parity: run_tokenflow_pnp.py:114-125 (picks the nframes_* dir with the
    MOST frames under steps_{n_inversion_steps}; truncates n_frames down to
    a batch_size multiple). When ``n_inversion_steps`` is None, any steps_*
    dir is considered (run_tokenflow_sdedit.py:81-92 globs across steps).
    """
    base = os.path.join(latents_dir, f"sd_{sd_version}", video_stem)
    if n_inversion_steps is not None:
        pattern = os.path.join(base, f"steps_{n_inversion_steps}", "*")
    else:
        pattern = os.path.join(base, "*", "*")
    candidates = [
        p
        for p in glob.glob(pattern)
        if "nframes_" in Path(p).name and "." not in Path(p).name
    ]
    if not candidates:
        raise FileNotFoundError(
            f"no inversion artifacts under {pattern}; run preprocess first"
        )
    n_frames_avail = [
        int(Path(p).name.split("_")[1]) for p in candidates
    ]
    best = candidates[int(np.argmax(n_frames_avail))]
    n = min(max(n_frames_avail), requested_frames)
    n -= n % batch_size
    return best, n


def write_inversion_prompt(
    save_dir: str, save_path: str, video_stem: str, prompt: str
) -> None:
    """inversion_prompt.txt + inversion_prompts.yaml registry
    (reference preprocess.py:311-314, util.py:31-44)."""
    registry = os.path.join(save_dir, "inversion_prompts.yaml")
    data = {}
    if os.path.exists(registry):
        with open(registry) as f:
            data = yaml.safe_load(f) or {}
    data[video_stem] = prompt
    with open(registry, "w") as f:
        yaml.dump(data, f)
    with open(os.path.join(save_path, "inversion_prompt.txt"), "w") as f:
        f.write(prompt)


def read_inversion_prompt(latents_path: str) -> str:
    """Reference run_tokenflow_pnp.py:107-112: the prompt file sits one
    level above the latents dir."""
    p = os.path.join(str(Path(latents_path).parent), "inversion_prompt.txt")
    with open(p) as f:
        return f.read()

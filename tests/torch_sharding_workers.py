"""The ranks of tests/test_torch_sharding.py: every sharded case on a gloo
group of CPU processes, importing torch and the port only (each rank is a
fresh spawned process). The test module writes the inputs; each rank
writes its results, rank 0 the gathered outputs.

Shared with the test module: the geometry of each case (``edit_case``)."""

from __future__ import annotations

import os

import numpy as np
import torch

HW, STEPS, F = 8, 2, 12  # latent size, edit steps, frames (divide over 2 and 3 ranks)
INV_STEPS = 4
EDIT_CASES = ("edit_loop", "pivotal_even", "pivotal_uneven", "straddle",
              "fewer_pivots_than_ranks", "prop_approx", "fused")


def edit_case(case: str, world: int) -> tuple[int, dict]:
    """(window, the loop's shard_pivotal, prop_approx and fused switches) of
    an edit case on ``world`` ranks of 12 frames: ``edit_loop`` runs the
    pivotal pass whole on every rank (the JAX test's ``sharded_edit_loop``
    default), ``pivotal_even`` splits 6 pivots evenly, ``pivotal_uneven`` 3
    over 2 (2 + 1) or 4 over 3 (2 + 1 + 1) with windows that straddle the
    ranks, ``straddle`` the same windows with the pivotal pass whole,
    ``fewer_pivots_than_ranks`` 1 over 2 or 2 over 3 (a rank holds no
    keyframe), ``prop_approx`` the approximate pass over split pivots,
    ``fused`` the single-pass step (every rank runs all the pivots beside
    its frames) on the straddling windows."""
    uneven = {2: 4, 3: 3}[world]
    window, shard, approx, fused = {
        "edit_loop": (2, False, False, False),
        "pivotal_even": (2, True, False, False),
        "pivotal_uneven": (uneven, True, False, False),
        "straddle": (uneven, False, False, False),
        "fewer_pivots_than_ranks": ({2: 12, 3: 6}[world], True, False, False),
        "prop_approx": (2, True, True, False),
        "fused": (uneven, True, False, True),
    }[case]
    return window, dict(shard_pivotal=shard, prop_approx=approx, fused=fused)


def edit_schedule():
    from tokenflow_torch.diffusion import ddim
    from tokenflow_torch.editing import pipeline

    sched = ddim.make_schedule(STEPS)
    return pipeline.make_edit_schedule(sched, sched.timesteps[::-1].copy(),
                                       pnp_attn_t=0.5, pnp_f_t=0.8)


def edit(model, inputs: dict, window: int, group=None, **kw) -> torch.Tensor:
    """The PnP edit loop on ``inputs`` (the rank's block of the frames over
    a ``group``)."""
    from tokenflow_torch.editing import pipeline

    x0, traj = torch.from_numpy(inputs["x0"]), torch.from_numpy(inputs["traj"])
    if group is not None:
        x0, traj = group.local(x0), group.local(traj, 1)
    return pipeline.tokenflow_sample_loop(
        model, x0, traj, torch.from_numpy(inputs["embeds3"]), edit_schedule(),
        window_size=window, guidance_scale=7.5, pnp=True,
        pivot_indices=inputs["pivots"][window], group=group, **kw)


def vanilla(model, inputs: dict, group=None) -> torch.Tensor:
    from tokenflow_torch.diffusion import ddim
    from tokenflow_torch.editing import pipeline

    sched = ddim.make_schedule(STEPS)
    x0 = torch.from_numpy(inputs["x0"])
    return pipeline.vanilla_sample_loop(
        model, x0 if group is None else group.local(x0),
        torch.from_numpy(inputs["embeds3"][1:]),
        pipeline.make_edit_schedule(sched, sched.timesteps[::-1].copy()),
        guidance_scale=7.5, frame_chunk=2)


def inversion_eps_fn(model, inputs: dict):
    cond = torch.from_numpy(inputs["embeds3"][2:3])

    def eps_fn(x, t):
        return model(x, t, cond.expand(x.shape[0], *cond.shape[1:]))[0]

    return eps_fn


def load_models(spec: dict):
    """The tiny UNet and the port's tiny stack with the JAX weights the
    test module wrote."""
    from tokenflow_torch import runtime
    from tokenflow_torch.models import unet2d

    weights = torch.load(spec["weights"])
    unet = unet2d.UNet2DConditionModel(unet2d.UNet2DConfig.tiny())
    unet.load_state_dict(weights["unet"], strict=True)
    stack = runtime.load_stack("tiny", device="cpu", dtype=torch.float32, init="random")
    stack.vae.load_state_dict(weights["vae"], strict=True)
    return unet.eval(), stack


def run_rank(rank: int, spec: dict) -> None:
    """Every case on this rank of ``spec["world"]``; writes
    ``spec["out"]``/rank<r>.pt."""
    from tokenflow_torch.diffusion import ddim
    from tokenflow_torch.kernels import flash_attention as fa
    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.ops.attention import flash_attention
    from tokenflow_torch.ops.propagation import propagation_indices
    from tokenflow_torch.sharding import mesh

    torch.set_num_threads(1)
    world = spec["world"]
    group = mesh.init_frames_group(rank, world, "cpu", init_method=spec["init"])
    unet, stack = load_models(spec)
    inputs = torch.load(spec["inputs"], weights_only=False)
    res = {"group": (group.rank, group.world, group.backend, group.transport)}

    with torch.inference_mode():
        for case in EDIT_CASES:
            window, switches = edit_case(case, world)
            out = edit(unet, inputs, window, group, **switches)
            res[case] = mesh.gather_to_rank0(group, out)
        res["vanilla"] = mesh.gather_to_rank0(group, vanilla(unet, inputs, group))

        lat = group.local(torch.from_numpy(inputs["x0"]) * 0.3)
        x_t, traj, _ = mesh.sharded_inversion(
            inversion_eps_fn(unet, inputs), lat, ddim.make_schedule(INV_STEPS), INV_STEPS,
            group)
        res["inversion"] = (mesh.gather_to_rank0(group, x_t),
                            mesh.gather_to_rank0(group, traj, axis=1))

        res["vae_decode"] = stack.decode_latents(group.local(torch.from_numpy(inputs["z"])),
                                                 batch=3, group=group)
        res["vae_encode"] = mesh.gather_to_rank0(
            group, stack.encode_frames(inputs["frames"], batch=3, group=group))

        res["checkpoint"] = checkpoint_case(unet, inputs, group, spec["ckpt_dir"])

        # B3's entries on their plain paths: the rank's query rows / frames
        # against the unsharded functions on the same seeded inputs
        rng = np.random.default_rng(9)
        kf, s, h, d = 5, 16, 2, 8
        q, k, v = (torch.from_numpy(rng.standard_normal((2, kf * s, h, d)).astype(np.float32))
                   for _ in range(3))
        counts = mesh.split_counts(kf, world)
        rows = slice(sum(counts[:rank]) * s, sum(counts[: rank + 1]) * s)
        got = fa.flash_attention_sharded(q[:, rows], k[:, rows], v[:, rows], group=group,
                                         kv_sizes=[c * s for c in counts], kv_block=24)
        res["flash_sharded"] = (got, flash_attention(q, k, v, kv_block=24)[:, rows])
        f, s, d = 12, 16, 8
        xq, ph = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((f, s, d), (3, s, d)))
        ph = ph / ph.norm(dim=-1, keepdim=True)
        table = torch.from_numpy(rng.standard_normal((3, 3, s, d)).astype(np.float32))
        pa, pb, w1 = (torch.as_tensor(a) for a in propagation_indices(f, 4))
        got = tm.token_match_gather_sharded(group.local(xq), ph, table, group.local(pa),
                                            group.local(pb), group.local(w1))
        want = tm.token_match_gather_plain(xq, ph, table, pa, pb, w1)
        res["match_sharded"] = (got, group.local(want, 1))
        res["bytes_sent"] = dict(group.bytes_sent)
    torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
    mesh.barrier(group)


def checkpoint_case(unet, inputs: dict, group, ckpt_dir: str) -> dict:
    """A checkpointed edit in two segments of one step over ``group``: the
    uninterrupted run, a run killed between the segments (on every rank),
    and the resumed run; the latents gathered on rank 0."""
    from tokenflow_torch.cli import common
    from tokenflow_torch.editing import pipeline
    from tokenflow_torch.sharding import mesh

    window = 2
    schedule = edit_schedule()
    pivots = inputs["pivots"][window]
    config = {"batch_size": window, "guidance_scale": 7.5, "steps_per_dispatch": 1,
              "checkpoint_edit": True, "output_path": ckpt_dir, "n_frames": F,
              "n_timesteps": STEPS, "seed": 1, "prompt": "mesh resume"}
    segments = common.schedule_segments(config, schedule, pivots)
    x_init = group.local(torch.from_numpy(inputs["x0"]))
    traj = group.local(torch.from_numpy(inputs["traj"]), 1)
    embeds3 = torch.from_numpy(inputs["embeds3"])

    def step_fn(x, sched_seg, piv_seg):
        return pipeline.tokenflow_sample_loop(
            unet, x, traj, embeds3, sched_seg, window_size=window, guidance_scale=7.5,
            pnp=True, pivot_indices=piv_seg, group=group)

    expected = common.run_segmented_edit(dict(config, checkpoint_edit=False), segments,
                                         step_fn, x_init, {}, group)
    calls = {"n": 0}

    def killing_step(x, sched_seg, piv_seg):
        if calls["n"] == 1:
            raise RuntimeError("simulated kill between segments")
        calls["n"] += 1
        return step_fn(x, sched_seg, piv_seg)

    killed = False
    try:
        common.run_segmented_edit(config, segments, killing_step, x_init, {}, group)
    except RuntimeError:
        killed = True
    mesh.barrier(group)
    path = os.path.join(ckpt_dir, "edit_checkpoint.npz")
    saved = os.path.exists(path)
    calls["n"] = 0

    def counted_step(x, sched_seg, piv_seg):
        calls["n"] += 1
        return step_fn(x, sched_seg, piv_seg)

    resumed = common.run_segmented_edit(config, segments, counted_step, x_init, {}, group)
    mesh.barrier(group)
    return {"segments": len(segments), "killed": killed, "saved": saved,
            "resumed_segments": calls["n"], "left": os.path.exists(path),
            "expected": mesh.gather_to_rank0(group, expected),
            "resumed": mesh.gather_to_rank0(group, resumed)}

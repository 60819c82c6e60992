"""Stage ``edit``: the TokenFlow edit loop, ``editing/pipeline.py::
tokenflow_sample_loop``, one denoising step a call (the schedule cut by
``split_schedule(schedule, 1)``, the same computation as one call), with
the arguments the editor CLIs give it (``cli/common.run_edit_loop``):
the traffic's editor ("pnp": PnP injection under its gates; "sdedit": the
schedule truncated at ``start``, no injection; "controlnet": the
ControlNet's residuals on every UNet call, canny images at 100/200), its
window, guidance and the program's defaults (two passes a step, exact
propagation; on the card the port's kernels, the GroupNorm kernel among
them, as its editors run them). Steps run from the schedule's first;
after its last the loop starts again from the same start latents.

The schedule is the configuration's (``program.py``), of the family its
``scheduler`` names (``reference/schedule.py``), and a scheduler or a
traffic the reference does not follow is refused by key and value before
anything is built. Under DDIM: the program's ``ddim.make_schedule`` on the
``scheduler``'s betas, training timesteps, ``steps_offset`` and
``set_alpha_to_one``, ``ddim.truncate_schedule`` at ``start`` and
``ddim.save_grid`` over those training timesteps: the numbers the
reference's tables are made of. Under rectified flow (a
``FlowMatchEulerDiscreteScheduler``): the port's
``flow.make_schedule(steps, num_train_timesteps=N, shift=s)``,
``flow.truncate_schedule(schedule, start)`` and
``flow.save_grid(save_steps, num_train_timesteps=N, shift=s)`` in
``tokenflow_torch/diffusion/flow.py``, called with the reference's
``flow_parameters``; their schedule and save grid then go to
``pipeline.make_edit_schedule`` as DDIM's do. Where the
``prediction_type`` is not "epsilon" the loop is handed
``prediction_type=<value>`` ("v_prediction"; "flow" for the velocity,
which the loop steps by Euler from sigma to sigma_next); a program whose
loop does not take it, or that has no flow entries, fails in set-up with
its own error (TypeError; ModuleNotFoundError) instead of sampling the
model as eps. That is the program's contract.

The inputs are the harness's: the start latents and a 50-slot source
trajectory made from seeded clean latents with DDIM's forward formula, or
flow's (1 - sigma) x0 + sigma eps (the edit costs the same whatever made
its trajectory), the embeddings, the architecture's further model inputs,
the pivot frames and the conditioning images. The models, those inputs and
the PnP sites come from the architecture's module (``run.arch``). The
program's own schedule tables come from its ``ddim`` (or ``flow``) and
``pipeline`` functions; the reference works them out again. A flow step is
also compared by its increment (``checks.step_numbers``' ``step_rel_l2``)."""

from __future__ import annotations

import torch

import checks
import inputs
import program
from reference import schedule, steps as ref_steps


class Stage:
    def __init__(self, run):
        from tokenflow_torch.diffusion import ddim
        from tokenflow_torch.editing import pipeline

        self.run, tr, arch = run, run.traffic, run.arch
        dev, dt = run.device, run.dtype
        # the reference's tables and the program's schedule on the configuration's
        # scheduler, refused here, before anything is built, where the reference
        # does not follow it
        self.tables = schedule.edit_tables(run.sched_config, tr)
        self.flow = self.tables["prediction_type"] == "flow"
        if self.flow:
            sched, save_ts = program.flow_schedule(run.sched_config, tr)
        else:
            sched = program.ddim_schedule(run.sched_config, tr["timesteps"])
            if tr.get("start") is not None:
                sched = ddim.truncate_schedule(sched, tr["start"])
            save_ts = ddim.save_grid(
                tr["inversion_steps"], tr["save_steps"],
                num_train_timesteps=run.sched_config["num_train_timesteps"])[0]
        self.prediction_kw = program.prediction_kw(run.sched_config)
        self.unet = arch.program_model("unet", run.unet_spec, run.state["unet"])
        self.controlnet = (None if run.controlnet_spec is None else arch.program_model(
            "controlnet", run.controlnet_spec, run.state["controlnet"]))
        frames = inputs.video(tr, run.seed, dev)
        x0 = inputs.latents(frames, run.seed)
        eps = inputs.noise(x0.shape, run.seed, dev)
        self.cond = None if self.controlnet is None else inputs.canny(frames).to(dt)
        del frames

        pnp = tr["editor"] == "pnp"
        gates = dict(pnp_attn_t=tr["pnp_attn_t"], pnp_f_t=tr["pnp_f_t"]) if pnp else {}
        self.steps = pipeline.split_schedule(
            pipeline.make_edit_schedule(sched, save_ts, **gates), 1)

        # the harness's inputs, handed to both sides
        self.x_init = inputs.start_latents(x0, eps, self.tables).to(dt)
        self.traj = inputs.source_trajectory(x0, eps, run.sched_config, tr["save_steps"]).to(dt)
        del x0, eps
        ctx = run.unet_spec.cross_attention_dim
        self.embeds3 = inputs.embeddings(3, ctx, run.seed, dev).to(dt)
        self.program_kw, self.reference_kw = arch.model_inputs(run.unet_spec, 3, run.seed,
                                                               dev, dt)
        self.pivots = inputs.pivots(len(self.steps), tr["frames"], tr["window"], run.seed)
        self.sample = checks.Sample(run.seed, tr["compared_later_steps"])
        self.x = self.x_init

    def _call(self, x, pos: int):
        from tokenflow_torch.editing import pipeline

        tr = self.run.traffic
        return pipeline.tokenflow_sample_loop(
            self.unet, x, self.traj, self.embeds3, self.steps[pos],
            window_size=tr["window"], guidance_scale=tr["guidance_scale"],
            pnp=tr["editor"] == "pnp", pivot_indices=self.pivots[pos : pos + 1],
            phase=self.run.phase, controlnet_fn=self.controlnet, cond_image=self.cond,
            **self.program_kw, **self.prediction_kw,
        )

    def warm(self) -> None:
        """The first step and the last, whose gates are off: every shape
        and path the window drives."""
        for pos in (0, len(self.steps) - 1):
            self._call(self.x_init, pos)

    def step(self, k: int, check: bool = True) -> None:
        """Step ``k`` of a window; ``check`` offers it to the comparison."""
        pos = k % len(self.steps)
        x_in = self.x_init if pos == 0 else self.x
        self.x = self._call(x_in, pos)
        if check:
            self.sample.offer((k, pos, x_in, self.x))

    def release(self) -> None:
        """Drop the program's models; the compared states stay."""
        self.unet = self.controlnet = None

    def compare(self, P, ref_unet, ref_controlnet, control=None) -> list:
        """The compared steps' numbers: the program's state after each
        against the reference's (precision ``P``) from the state before it;
        with ``control`` (a precision), that precision's reference step
        stands in for the program's."""
        tr = self.run.traffic
        pa, pb, w1 = (torch.as_tensor(a, device=self.run.device)
                      for a in schedule.propagation_indices(tr["frames"], tr["window"]))
        inject = self.run.arch.inject_sites(self.run.unet_spec)

        def ref(prec, x_in, pos):
            return ref_steps.edit_step(
                prec, ref_unet, ref_controlnet, x_in, self.traj[int(self.tables["slot"][pos])],
                self.embeds3, self.tables, pos, self.pivots[pos], tr, inject, cond=self.cond,
                pa=pa, pb=pb, w1=w1, model_kw=self.reference_kw)

        out = []
        for k, pos, x_in, x_out in self.sample.items():
            if control is not None:
                x_out = ref(control, x_in, pos).to(x_in.dtype)
            out.append({"step": k, "position": pos,
                        "numbers": checks.step_numbers(x_out, ref(P, x_in, pos),
                                                       x_in if self.flow else None)})
        return out

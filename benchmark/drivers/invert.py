"""Stage ``invert``: DDIM inversion, ``diffusion/inversion.py::
ddim_inversion``, one step a call (``steps=slice(i, i + 1)`` with the
previous call's ``carry``), on the eps of ``cli/preprocess.build_eps_fn``
at preprocess's defaults: all frames in one chunk, the inversion prompt's
embedding alone (no guidance), the ControlNet's residuals where the
configuration has one, and the architecture's further model inputs (its
module, ``run.arch``, builds the models too). Steps run over the
traffic's schedule from its first; after its last the loop starts again
from the clean latents and an empty trajectory. Compared: the state after
sampled steps, and the trajectory slots the window wrote.

The schedule is the configuration's, as in the edit stage
(``drivers/edit.py``, ``program.py``): a scheduler the reference does not
follow, a flow scheduler among them (TokenFlow defines no flow inversion),
is refused before anything is built, and where the
``prediction_type`` is not "epsilon" the inversion is handed
``prediction_type=<value>``; a program whose inversion does not take it
fails in set-up with its own TypeError. That is the program's contract."""

from __future__ import annotations

import types

import checks
import inputs
import program
from reference import schedule, steps as ref_steps


class Stage:
    def __init__(self, run):
        from tokenflow_torch.cli.preprocess import build_eps_fn

        self.run, tr, arch = run, run.traffic, run.arch
        dev, dt = run.device, run.dtype
        self.tables = schedule.inversion_tables(run.sched_config, tr)
        self.sched = program.ddim_schedule(run.sched_config, tr["timesteps"])
        self.prediction_kw = program.prediction_kw(run.sched_config)
        self.unet = arch.program_model("unet", run.unet_spec, run.state["unet"])
        self.controlnet = (None if run.controlnet_spec is None else arch.program_model(
            "controlnet", run.controlnet_spec, run.state["controlnet"]))
        frames = inputs.video(tr, run.seed, dev)
        self.latents = inputs.latents(frames, run.seed)
        self.cond = None if self.controlnet is None else inputs.canny(frames).to(dt)
        del frames
        self.embed = inputs.embeddings(1, run.unet_spec.cross_attention_dim, run.seed,
                                       dev).to(dt)
        program_kw, self.reference_kw = arch.model_inputs(run.unet_spec, 1, run.seed, dev, dt)
        # build_eps_fn reads the stack's UNet entry and dtype alone
        stack = types.SimpleNamespace(unet_apply=self.unet, dtype=dt)
        self.eps_fn = build_eps_fn(stack, self.embed, None, self.controlnet, self.cond,
                                   **program_kw)
        self.carry = None
        self.sample = checks.Sample(run.seed, tr["compared_later_steps"])
        self.saved = checks.Sample(run.seed + 1, size=0)

    def _call(self, pos: int, carry):
        from tokenflow_torch.diffusion import inversion

        x, traj, _ = inversion.ddim_inversion(
            self.eps_fn, self.latents, self.sched, self.run.traffic["save_steps"],
            steps=slice(pos, pos + 1), carry=carry, **self.prediction_kw)
        return x, traj

    def warm(self) -> None:
        self._call(0, None)

    def step(self, k: int, check: bool = True) -> None:
        """Step ``k`` of a window; ``check`` offers it to the comparison."""
        pos = k % len(self.tables["t"])
        carry = None if pos == 0 else self.carry
        x_in = self.latents if carry is None else carry[0]
        self.carry = self._call(pos, carry)
        if not check:
            return
        self.last = (pos, self.carry[1])
        item = (k, pos, x_in, self.carry[0])
        self.sample.offer(item)
        if self.tables["slot"][pos] >= 0:
            self.saved.offer((*item, self.carry[1]))

    def release(self) -> None:
        self.unet = self.controlnet = self.eps_fn = None

    def _slots_wrong(self) -> int:
        """Slots of the last checked trajectory that hold a row where the
        schedule wrote none so far in its cycle, or none where it wrote one."""
        last_pos, traj = self.last
        written = {int(s) for s in self.tables["slot"][: last_pos + 1] if s >= 0}
        filled = traj.flatten(1).abs().amax(dim=1) > 0
        return sum(bool(filled[j]) != (j in written) for j in range(traj.shape[0]))

    def compare(self, P, ref_unet, ref_controlnet, control=None) -> list:
        """As the edit stage's, and the trajectory: the slot a compared
        saving step wrote holds its state (``slot_gap``), and the last
        trajectory holds rows exactly where the schedule wrote them
        (``slots_wrong``)."""
        def ref(prec, x_in, pos):
            return ref_steps.inversion_step(prec, ref_unet, ref_controlnet, x_in, self.embed,
                                            self.tables, pos, cond=self.cond,
                                            model_kw=self.reference_kw)

        out = []
        saved = {it[0]: it for it in self.saved.items()}
        items = self.sample.items()
        items += [it[:4] for k, it in saved.items() if k not in {i[0] for i in items}]
        for k, pos, x_in, x_out in sorted(items, key=lambda it: it[0]):
            gap = {}
            if k in saved:
                row = saved[k][4][int(self.tables["slot"][pos])]
                gap["slot_gap"] = float((row.float() - x_out.float()).abs().max())
            if control is not None:
                x_out = ref(control, x_in, pos).to(x_in.dtype)
            numbers = {**checks.step_numbers(x_out, ref(P, x_in, pos)), **gap}
            out.append({"step": k, "position": pos, "numbers": numbers})
        out.append({"step": None, "position": None,
                    "numbers": {"slots_wrong": float(self._slots_wrong())}})
        return out

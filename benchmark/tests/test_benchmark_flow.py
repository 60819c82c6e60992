"""Rectified flow reaches both sides of the check: the flow grid of
diffusers' ``FlowMatchEulerDiscreteScheduler`` with a static shift, SDEdit's
truncation and the save grid on it, the reference's Euler step, the edit
driver's flow inputs, the program's contract (the port's
``tokenflow_torch.diffusion.flow`` entries, the loop told
``prediction_type="flow"``) and ``step_rel_l2``, the compared increment of
a flow step. Every DDIM configuration and traffic of the benchmark is
rebuilt as before: its tables bit for bit against digests of the previous
harness's, its start latents and trajectory against that harness's
formulas, its compared numbers under the same two names. Tiny cells on the
CPU, the harness's look for a card skipped."""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import re
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
TESTS = BENCH / "tests"
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(TESTS)]

import checks  # noqa: E402
import harness  # noqa: E402
import inputs  # noqa: E402
import manifest  # noqa: E402
import tiny  # noqa: E402
from reference import schedule  # noqa: E402
from reference import steps as ref_steps  # noqa: E402
from reference.precision import Precision  # noqa: E402
import tokenflow_torch.diffusion  # noqa: E402
from tokenflow_torch.editing import pipeline  # noqa: E402

SEED = 3000000028
FLOW = {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000,
        "shift": 3.0}
EDIT_LIMITS = {"state_rel_l2": 0.17, "frame_rel_l2": 0.22}
# the tiny flow cell's limit of the compared increment: the reference stands
# in for the program in these tests and reads 0
FLOW_LIMITS = dict(EDIT_LIMITS, step_rel_l2=0.05)
INVERT_LIMITS = {"state_rel_l2": 0.015, "frame_rel_l2": 0.018, "slot_gap": 0.0,
                 "slots_wrong": 0.0}
# SDEdit at the 1024^2 cell's schedule (50 steps from 0.9): the early steps,
# where a flow step moves the state least
FLOW_SDEDIT = dict(tiny.TINY_EDIT, editor="sdedit", start=0.9, timesteps=50, save_steps=50)
CONFIGS = {"tiny_flow": {"transformer": tiny.TINY_UNET, "unet": None,
                         "architecture": "transformer_test", "scheduler": FLOW}}
CELLS = {"tiny_flow_edit": ("tiny_flow", "tiny_flow_sdedit"),
         "tiny_flow_pnp": ("tiny_flow", "tiny_pnp"),
         "tiny_flow_invert": ("tiny_flow", "tiny_invert")}
# an unfollowed flow key and value: each is refused by name
REFUSED = [("use_dynamic_shifting", True), ("invert_sigmas", True),
           ("use_karras_sigmas", True), ("use_exponential_sigmas", True),
           ("use_beta_sigmas", True), ("stochastic_sampling", True),
           ("shift_terminal", 0.02), ("shift", 0.0), ("shift", -1.0), ("shift", None)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"),
        lambda cell: INVERT_LIMITS if "invert" in cell else FLOW_LIMITS,
        cells=CELLS, configs=CONFIGS, traffic={"tiny_flow_sdedit": FLOW_SDEDIT})
    shutil.copy(TESTS / "transformer_arch.py", r / "architectures" / "transformer_test.py")
    return r


def _args(cell: str, seed: int = SEED):
    return harness.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                          "--trace", "0"])


def _no_program_model(monkeypatch, cell):
    def program_model(*args, **kw):
        raise AssertionError("the program's model was built")

    monkeypatch.setattr(cell.arch, "program_model", program_model)


# ---------------------------------------------------------------------------
# the flow grid
# ---------------------------------------------------------------------------


def test_the_flow_grid_is_diffusers_static_shift_grid():
    """N = 1000, shift 3, 50 steps: the sigmas and timesteps that diffusers'
    scheduler gives, and the training grid's sigma_min."""
    sigma = schedule.flow_sigmas(FLOW, 50)
    assert sigma.dtype == np.float32 and sigma.shape == (50,)
    want = {0: 1.0, 1: 0.9931244, 2: 0.9860570, 47: 0.1205327, 48: 0.0669002, 49: 0.0089286}
    for i, s in want.items():
        assert abs(float(sigma[i]) - s) < 1e-6, (i, float(sigma[i]), s)
    tables = schedule.edit_tables(FLOW, {"timesteps": 50, "save_steps": 50})
    assert tables["t"].dtype == np.float32 and abs(float(tables["t"][49]) - 8.928572) < 1e-5
    np.testing.assert_array_equal(tables["t"], sigma * np.float32(1000))
    train = schedule.flow_train_sigmas(FLOW)
    assert train.dtype == np.float32 and float(train[0]) == 1.0
    assert abs(float(train[-1]) - 0.0029940) < 1e-7
    assert schedule.flow_parameters(FLOW) == {"num_train_timesteps": 1000, "shift": 3.0}


def test_sdedit_truncates_the_flow_grid_by_index():
    """Start 0.9 on 50 steps leaves 44 (``[int(1 - 0.9 * 50):]``), from
    sigma 0.9557004 to next 0.9475426; the last step ends at sigma 0; each
    step's slot is its index into the ascending save grid."""
    tables = schedule.edit_tables(FLOW, {"timesteps": 50, "save_steps": 50, "start": 0.9})
    assert tables["prediction_type"] == "flow"
    assert len(tables["t"]) == 44
    assert abs(float(tables["sigma"][0]) - 0.9557004) < 1e-6
    assert abs(float(tables["sigma_next"][0]) - 0.9475426) < 1e-6
    assert float(tables["sigma_next"][-1]) == 0.0
    np.testing.assert_array_equal(tables["sigma_next"][:-1], tables["sigma"][1:])
    np.testing.assert_array_equal(tables["slot"], np.arange(43, -1, -1))
    save = schedule.flow_sigmas(FLOW, 50)[::-1]
    np.testing.assert_array_equal(save[tables["slot"]], tables["sigma"])
    full = schedule.edit_tables(FLOW, {"timesteps": 50, "save_steps": 50})
    np.testing.assert_array_equal(full["sigma"][6:], tables["sigma"])


@pytest.mark.parametrize("keys", [{}, {"shift": 1}, {"use_dynamic_shifting": False,
                                                      "shift_terminal": None},
                                  {"base_shift": 0.5, "max_shift": 1.15,
                                   "base_image_seq_len": 256, "max_image_seq_len": 4096,
                                   "time_shift_type": "exponential"},
                                  {"invert_sigmas": False, "use_karras_sigmas": False,
                                   "use_exponential_sigmas": False, "use_beta_sigmas": False,
                                   "stochastic_sampling": False}])
def test_the_followed_flow_values_pass(keys):
    """Followed values pass; the dynamic-shifting keys are accepted and
    change nothing."""
    sched = dict(FLOW, **keys)
    schedule.check(sched)
    assert schedule.prediction_type(sched) == "flow"
    if "shift" not in keys:
        np.testing.assert_array_equal(schedule.flow_sigmas(sched, 50),
                                      schedule.flow_sigmas(FLOW, 50))


@pytest.mark.parametrize("key,value", REFUSED)
@pytest.mark.parametrize("cell", ["tiny_flow_edit", "tiny_flow_pnp"])
def test_an_unfollowed_flow_key_is_refused_by_name(root, cell, key, value, monkeypatch):
    """Refused in the stage's set-up, naming the key and the value, before
    the program's model is built."""
    c = manifest.cell(cell, root)
    c.config["scheduler"] = dict(c.config["scheduler"], **{key: value})
    _no_program_model(monkeypatch, c)
    with pytest.raises(ValueError, match=re.escape(f"scheduler {key}={value!r}")):
        harness.run_cell(c, _args(cell), time.monotonic(), root, torch.device("cpu"))


def test_a_flow_edit_off_its_save_grid_is_refused_by_name(root, monkeypatch):
    c = manifest.cell("tiny_flow_edit", root)
    c.traffic = dict(c.traffic, timesteps=25)
    _no_program_model(monkeypatch, c)
    with pytest.raises(ValueError, match="timesteps=25 save_steps=50"):
        harness.run_cell(c, _args(c.name), time.monotonic(), root, torch.device("cpu"))


def test_a_flow_inversion_is_refused_by_name(root, monkeypatch):
    c = manifest.cell("tiny_flow_invert", root)
    _no_program_model(monkeypatch, c)
    with pytest.raises(ValueError, match="FlowMatchEulerDiscreteScheduler.*no flow inversion"):
        harness.run_cell(c, _args(c.name), time.monotonic(), root, torch.device("cpu"))


def test_the_families_refuse_each_other_s_parameters():
    with pytest.raises(ValueError, match="not of the DDIM family"):
        schedule.ddim_parameters(FLOW)
    sd21 = json.loads((BENCH / "configs" / "sd21.json").read_text())["scheduler"]
    with pytest.raises(ValueError, match="not of the flow family"):
        schedule.flow_parameters(sd21)


# ---------------------------------------------------------------------------
# the reference's flow step
# ---------------------------------------------------------------------------


def _velocity_model(v_of):
    """A model whose output is ``v_of(sample, t)`` for every stream."""
    def model(P, sample, t, ctx, edit=None, **kw):
        return v_of(sample.float(), t), None

    return model


def _step(tables, i, x, model):
    f = x.shape[0]
    traffic = {"guidance_scale": 7.5, "editor": "sdedit"}
    pa, pb, w1 = (torch.as_tensor(a) for a in schedule.propagation_indices(f, 2))
    embeds3 = torch.zeros((3, 77, 8))
    return ref_steps.edit_step(Precision("fp32"), model, None, x, x, embeds3, tables, i,
                               [0, 2], traffic, (frozenset(), None), pa=pa, pb=pb, w1=w1)


def test_the_reference_s_flow_step_is_euler_between_x0_and_eps():
    """x' = (1 - s') x0^ + s' eps^, with x0^ = x - s v and eps^ = x + (1 - s) v,
    to fp32 rounding; the model sees the float t = s N; with the exact
    velocity eps - x0 a step lands on the next level's noised latents."""
    tables = schedule.edit_tables(FLOW, {"timesteps": 10, "save_steps": 10})
    gen = torch.Generator().manual_seed(7)
    f, hw = 4, 8
    x0 = torch.randn((1, hw, hw, 4), generator=gen)
    eps = torch.randn((f, hw, hw, 4), generator=gen)
    v = torch.randn((3 * f, hw, hw, 4), generator=gen)
    seen = []

    def fixed(sample, t):
        seen.append(t)
        return v[: len(sample)]

    for i in range(len(tables["t"])):
        s, s_next = float(tables["sigma"][i]), float(tables["sigma_next"][i])
        x = (1 - s) * x0 + s * eps
        out = _step(tables, i, x, _velocity_model(fixed))
        # the guided velocity: streams [src, uncond, cond] frame-major
        v3 = v[: 3 * f].reshape(f, 3, hw, hw, 4)
        guided = v3[:, 1] + 7.5 * (v3[:, 2] - v3[:, 1])
        x0_hat, eps_hat = x - s * guided, x + (1 - s) * guided
        torch.testing.assert_close(out, (1 - s_next) * x0_hat + s_next * eps_hat,
                                   rtol=1e-5, atol=1e-5)
        assert all(isinstance(t, float) for t in seen) and seen[-1] == float(tables["t"][i])
        # the exact velocity eps - x0 of a sample at sigma = t / N
        exact = _step(tables, i, x, _velocity_model(lambda smp, t: (smp - x0) / (t / 1000)))
        torch.testing.assert_close(exact, (1 - s_next) * x0 + s_next * eps, rtol=2e-5,
                                   atol=2e-5)


def test_the_ddim_paths_still_call_the_model_with_integer_t():
    sd21 = json.loads((BENCH / "configs" / "sd21.json").read_text())["scheduler"]
    tables = schedule.edit_tables(sd21, {"timesteps": 10, "save_steps": 10})
    seen = []
    x = torch.randn((4, 8, 8, 4), generator=torch.Generator().manual_seed(1))
    _step(tables, 0, x, _velocity_model(lambda smp, t: seen.append(t) or torch.zeros_like(smp)))
    assert seen and all(type(t) is int for t in seen)


# ---------------------------------------------------------------------------
# step_rel_l2
# ---------------------------------------------------------------------------


def test_step_rel_l2_reads_the_increment():
    gen = torch.Generator().manual_seed(3)
    x_in = torch.randn((4, 8, 8, 4), generator=gen, dtype=torch.float64)
    x_ref = x_in + 0.01 * torch.randn((4, 8, 8, 4), generator=gen, dtype=torch.float64)
    same = checks.step_numbers(x_ref.clone(), x_ref, x_in)
    assert same["step_rel_l2"] == 0.0 and same["state_rel_l2"] == 0.0
    for c in (0.0, 0.5, 1.1, 3.0):  # the increment scaled by c
        n = checks.step_numbers(x_in + c * (x_ref - x_in), x_ref, x_in)
        assert abs(n["step_rel_l2"] - abs(c - 1)) < 1e-12
        assert n["state_rel_l2"] < 0.02 * max(abs(c - 1), 1e-9) + 1e-12
    assert set(checks.step_numbers(x_ref, x_ref)) == {"state_rel_l2", "frame_rel_l2"}


# ---------------------------------------------------------------------------
# the program's contract
# ---------------------------------------------------------------------------


def test_a_flow_configuration_runs_only_where_the_program_has_flow(root, monkeypatch, capsys):
    """On a port without ``tokenflow_torch.diffusion.flow`` the run fails in
    the stage's set-up with the program's own error, before the program's
    models are built and the window is reached; on one with it, the run
    reports ``step_rel_l2``."""
    if importlib.util.find_spec("tokenflow_torch.diffusion.flow") is not None:
        rc = harness.main(["--workload", "tiny_flow_edit", "--seed", str(SEED), "--seconds",
                           "0.5", "--trace", "0"], time.monotonic(), root=root,
                          device=torch.device("cpu"))
        assert rc == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "step_rel_l2" in result["checks"]
        return
    c = manifest.cell("tiny_flow_edit", root)
    _no_program_model(monkeypatch, c)

    def window(*args, **kw):
        raise AssertionError("the window was reached")

    monkeypatch.setattr(harness, "window", window)
    with pytest.raises(ModuleNotFoundError, match=r"tokenflow_torch\.diffusion\.flow"):
        harness.run_cell(c, _args(c.name), time.monotonic(), root, torch.device("cpu"))


class ReferenceProgram:
    """The port's flow entries and edit loop as the contract names them,
    stood in for by the reference (fp32, on the program's own model, which
    is the reference model on the run's weights), with ``fault`` planted in
    the loop's output: None, "unchanged" (the state returned as it came),
    "half_batch" (the second half of the frames the mean of the first) or
    "answer_altered" (one frame's latents scaled where they are made)."""

    def __init__(self, cell, fault=None):
        self.cell, self.fault = cell, fault
        self.calls: dict = {"make_schedule": [], "save_grid": [], "loop": []}
        self.tables = schedule.edit_tables(cell.config["scheduler"], cell.traffic)

    def install(self, monkeypatch):
        flow = types.ModuleType("tokenflow_torch.diffusion.flow")
        flow.make_schedule = self.make_schedule
        flow.truncate_schedule = lambda s, start: s[int(1 - start * len(s)):]
        flow.save_grid = self.save_grid
        monkeypatch.setitem(sys.modules, flow.__name__, flow)
        monkeypatch.setattr(tokenflow_torch.diffusion, "flow", flow, raising=False)
        monkeypatch.setattr(pipeline, "make_edit_schedule",
                            lambda s, save, **gates: list(range(len(s))))
        monkeypatch.setattr(pipeline, "split_schedule", lambda s, n: s)
        monkeypatch.setattr(pipeline, "tokenflow_sample_loop", self.loop)
        c = self.cell
        monkeypatch.setattr(c.arch, "program_model", lambda kind, spec, sd: c.arch.reference_model(
            "unet", c.config[c.denoiser_group], sd))

    def _sched(self, num_train_timesteps, shift):
        return dict(FLOW, num_train_timesteps=num_train_timesteps, shift=shift)

    def make_schedule(self, steps, *, num_train_timesteps, shift):
        self.calls["make_schedule"].append((steps, num_train_timesteps, shift))
        return schedule.flow_sigmas(self._sched(num_train_timesteps, shift), steps)

    def save_grid(self, save_steps, *, num_train_timesteps, shift):
        self.calls["save_grid"].append((save_steps, num_train_timesteps, shift))
        sigma = schedule.flow_sigmas(self._sched(num_train_timesteps, shift), save_steps)
        return (sigma[::-1] * np.float32(num_train_timesteps)).astype(np.float32)

    def loop(self, model, x, traj, embeds3, pos, *, pivot_indices, prediction_type, **kw):
        tr = self.cell.traffic
        self.calls["loop"].append((prediction_type, x.clone(), traj))
        pa, pb, w1 = (torch.as_tensor(a) for a in schedule.propagation_indices(tr["frames"],
                                                                              tr["window"]))
        out = ref_steps.edit_step(
            Precision("fp32"), model, None, x, traj[int(self.tables["slot"][pos])], embeds3,
            self.tables, pos, pivot_indices[0], tr, self.cell.arch.inject_sites(None),
            pa=pa, pb=pb, w1=w1)
        if self.fault == "unchanged":
            return x
        half = len(out) // 2
        if self.fault == "half_batch":
            out[half:] = out[:half].mean(dim=0, keepdim=True)
        elif self.fault == "answer_altered":
            out[0] = out[0] * 1.5
        return out


def _flow_run(root, monkeypatch, fault=None, steps=3):
    c = manifest.cell("tiny_flow_edit", root)
    prog = ReferenceProgram(c, fault)
    prog.install(monkeypatch)
    monkeypatch.setattr(harness, "window", tiny.fixed_window(steps))
    out = harness.run_cell(c, _args(c.name), time.monotonic(), root, torch.device("cpu"))
    return c, prog, harness.decide(c, out["compared"])


def test_the_harness_s_flow_path_with_the_reference_in_the_program_s_place(root,
                                                                           monkeypatch):
    """The program's flow entries get the reference's ``flow_parameters``,
    the loop ``prediction_type="flow"``, the start latents (1 - s0) x0 +
    s0 eps and the trajectory at the ascending save grid's sigmas; the
    reference in the program's place reads 0 on every compared number."""
    c, prog, (correct, failed, checked) = _flow_run(root, monkeypatch)
    assert correct is True and failed == 0
    assert set(checked) == {"state_rel_l2", "frame_rel_l2", "step_rel_l2"}
    assert all(v == 0.0 for v, _ in checked.values())
    assert prog.calls["make_schedule"] == [(50, 1000, 3.0)]
    assert prog.calls["save_grid"] == [(50, 1000, 3.0)]
    assert {p for p, _, _ in prog.calls["loop"]} == {"flow"}
    dt = torch.bfloat16
    x0 = inputs.latents(inputs.video(c.traffic, SEED, "cpu"), SEED)
    eps = inputs.noise(x0.shape, SEED, "cpu")
    s0 = float(prog.tables["sigma"][0])
    _, x_first, traj = prog.calls["loop"][0]
    assert torch.equal(x_first, ((1 - s0) * x0 + s0 * eps).to(dt))
    save = torch.as_tensor(schedule.flow_sigmas(FLOW, 50)[::-1].copy())
    for j in (0, 7, 49):
        assert torch.equal(traj[j], ((1 - save[j]) * x0 + save[j] * eps).to(dt))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
def test_a_broken_flow_step_is_not_correct(root, monkeypatch, fault):
    """Each fault fails a compared number. A state returned unchanged moves
    the state readings by the step's small share of the velocity, under
    their limits: only ``step_rel_l2`` sees it."""
    _, _, (correct, failed, checked) = _flow_run(root, monkeypatch, fault)
    assert correct is False and failed >= 1
    if fault == "unchanged":
        assert checked["step_rel_l2"][0] > 0.99
        assert checked["state_rel_l2"][0] < checked["state_rel_l2"][1]
        assert checked["frame_rel_l2"][0] < checked["frame_rel_l2"][1]


# ---------------------------------------------------------------------------
# every DDIM configuration and traffic reads as before
# ---------------------------------------------------------------------------

# sha256 (first 16 hex digits) of each configuration's tables on each
# traffic, as the harness before rectified flow built them
PARENT_TABLES = {
    "hunyuandit_v12-controlnet512_edit": "a61f51a3193d4c7d",
    "hunyuandit_v12-invert512": "cf22735da0c68fe7",
    "hunyuandit_v12-pnp512_edit": "ece0c653487d59f6",
    "hunyuandit_v12-sdedit1024_edit": "2ec7e24786f2fb06",
    "hunyuandit_v12-sdedit768_edit": "2ec7e24786f2fb06",
    "sd15_controlnet-controlnet512_edit": "e7404d3cf9fe711a",
    "sd15_controlnet-invert512": "aab88466d7d1dd99",
    "sd15_controlnet-pnp512_edit": "0d1c60965d813c92",
    "sd15_controlnet-sdedit1024_edit": "8ab73668e87ede7f",
    "sd15_controlnet-sdedit768_edit": "8ab73668e87ede7f",
    "sd21-controlnet512_edit": "e7404d3cf9fe711a",
    "sd21-invert512": "aab88466d7d1dd99",
    "sd21-pnp512_edit": "0d1c60965d813c92",
    "sd21-sdedit1024_edit": "8ab73668e87ede7f",
    "sd21-sdedit768_edit": "8ab73668e87ede7f",
    "sdxl-controlnet512_edit": "e7404d3cf9fe711a",
    "sdxl-invert512": "aab88466d7d1dd99",
    "sdxl-pnp512_edit": "0d1c60965d813c92",
    "sdxl-sdedit1024_edit": "8ab73668e87ede7f",
    "sdxl-sdedit768_edit": "8ab73668e87ede7f",
}
CONFIG_NAMES = sorted(p.stem for p in BENCH.glob("configs/*.json"))
TRAFFIC_NAMES = sorted(p.stem for p in BENCH.glob("traffic/*.json"))


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def _digest(tables: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tables):
        v = tables[k]
        h.update(k.encode())
        if isinstance(v, str):
            h.update(v.encode())
        else:
            a = np.ascontiguousarray(v)
            h.update(a.dtype.str.encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("traffic", TRAFFIC_NAMES)
@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_the_previous_tables_are_rebuilt_bit_for_bit(config, traffic):
    sched, tr = _load("configs", config)["scheduler"], _load("traffic", traffic)
    tables = (schedule.inversion_tables if tr["stage"] == "invert" else
              schedule.edit_tables)(sched, tr)
    assert _digest(tables) == PARENT_TABLES[f"{config}-{traffic}"]


def _stub_unet(P, sample, t, ctx, edit=None, **kw):
    return torch.zeros_like(sample), None


def _stub_controlnet(P, sample, t, ctx, cond, **kw):
    return [], None


@pytest.mark.parametrize("traffic", [t for t in TRAFFIC_NAMES
                                     if _load("traffic", t)["stage"] == "edit"])
@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_the_previous_edit_inputs_and_numbers_are_rebuilt(config, traffic, monkeypatch):
    """Each configuration's edit stage on each edit traffic (its frames cut
    to one window at 64^2; the schedule as the traffic states): the start
    latents and the source trajectory are the previous harness's DDIM
    formulas bit for bit, no flow entry of the program is reached, and a
    compared step reads the same two numbers as before."""
    cfg = _load("configs", config)
    tr = dict(_load("traffic", traffic), frames=8, resolution=64, motion_px=2)
    arch = manifest.architecture(cfg.get("architecture", manifest.DEFAULT_ARCHITECTURE))
    cell = manifest.Cell(name=f"{config}-{traffic}", chips=1, config=cfg, traffic=tr,
                         limits={}, end_to_end=[], per_layer=[], arch=arch)
    monkeypatch.setattr(arch, "program_model", lambda kind, spec, sd: object())
    monkeypatch.setitem(sys.modules, "tokenflow_torch.diffusion.flow", None)
    unet_spec, cn_spec = arch.specs(cfg)
    dt = torch.bfloat16
    run = harness.Run(cell, SEED, torch.device("cpu"), dt, unet_spec, cn_spec,
                      {"unet": None, "controlnet": None}, lambda name: contextlib.nullcontext())
    stage = manifest.driver("edit").Stage(run)
    assert not stage.flow and stage.prediction_kw == (
        {} if cfg["scheduler"].get("prediction_type", "epsilon") == "epsilon"
        else {"prediction_type": cfg["scheduler"]["prediction_type"]})

    sched = cfg["scheduler"]
    x0 = inputs.latents(inputs.video(tr, SEED, "cpu"), SEED)
    eps = inputs.noise(x0.shape, SEED, "cpu")
    ac = schedule.alphas_cumprod(sched)
    ac0 = float(ac[stage.tables["t"][0]])
    assert torch.equal(stage.x_init, (ac0**0.5 * x0 + (1 - ac0) ** 0.5 * eps).to(dt))
    a = torch.as_tensor(ac[schedule.save_grid(sched, tr["save_steps"])])[:, None, None, None,
                                                                          None]
    assert torch.equal(stage.traj, (torch.sqrt(a) * x0[None]
                                    + torch.sqrt(1 - a) * eps[None]).to(dt))

    stage.release()
    x_in = stage.x_init
    stage.sample.offer((0, 0, x_in, x_in.float() * 1.01))
    compared = stage.compare(Precision("fp32"), _stub_unet,
                             None if cn_spec is None else _stub_controlnet)
    assert [set(c["numbers"]) for c in compared] == [{"state_rel_l2", "frame_rel_l2"}]


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_the_benchmark_s_cells_keep_their_limits(cell):
    """Every cell's limits name the numbers its stage compares under its
    configuration's family: none of today's cells is a flow cell."""
    c = manifest.cell(cell)
    assert not schedule.is_flow(c.config["scheduler"])
    names = {"state_rel_l2", "frame_rel_l2"}
    if c.stage == "invert":
        names |= {"slot_gap", "slots_wrong"}
    assert set(c.limits) == names

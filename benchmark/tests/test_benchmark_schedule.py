"""A configuration's ``scheduler`` reaches both sides of the check: the
program's DDIM is built from its betas, offset and final alpha as the
reference's tables are; the reference turns a v-prediction output into eps
and x0; the program is told the prediction type; a scheduler the reference
does not follow is refused by key and value before anything is built; and
the architecture module names the denoiser's configuration group. Tiny
cells on the CPU, the harness's look for a card skipped."""

from __future__ import annotations

import inspect
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
TESTS = BENCH / "tests"
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(TESTS)]

import harness  # noqa: E402
import manifest  # noqa: E402
import program  # noqa: E402
import tiny  # noqa: E402
from reference import schedule  # noqa: E402
from reference import steps as ref_steps  # noqa: E402
from reference.precision import Precision  # noqa: E402
from tokenflow_torch.diffusion import ddim, inversion  # noqa: E402
from tokenflow_torch.editing import pipeline  # noqa: E402

# the tiny cells' limits (test_benchmark_correct.py)
EDIT_LIMITS = {"state_rel_l2": 0.17, "frame_rel_l2": 0.22}
INVERT_LIMITS = {"state_rel_l2": 0.015, "frame_rel_l2": 0.018, "slot_gap": 0.0,
                 "slots_wrong": 0.0}
SEED = 3000000023
SD21 = json.loads((BENCH / "configs" / "sd21.json").read_text())["scheduler"]
HUNYUAN_LIKE = dict(SD21, beta_end=0.03, prediction_type="v_prediction",
                    timestep_spacing="leading")
CONFIGS = {
    "tiny_b03": {"unet": tiny.TINY_UNET, "scheduler": dict(SD21, beta_end=0.03)},
    "tiny_v": {"unet": tiny.TINY_UNET, "scheduler": HUNYUAN_LIKE},
    "tiny_dit": {"transformer": tiny.TINY_UNET, "unet": None,
                 "architecture": "transformer_test"},
}
CELLS = {
    "tiny_pnp_edit": ("tiny", "tiny_pnp"),
    "tiny_invert": ("tiny", "tiny_invert"),
    "tiny_b03_edit": ("tiny_b03", "tiny_pnp"),
    "tiny_b03_sdedit": ("tiny_b03", "tiny_sdedit"),
    "tiny_b03_invert": ("tiny_b03", "tiny_invert"),
    "tiny_v_edit": ("tiny_v", "tiny_pnp"),
    "tiny_v_invert": ("tiny_v", "tiny_invert"),
    "tiny_dit_edit": ("tiny_dit", "tiny_pnp"),
    "tiny_dit_invert": ("tiny_dit", "tiny_invert"),
}
# a scheduler key and a value the reference does not follow
REFUSED = [
    ("beta_schedule", "linear"), ("beta_schedule", "squaredcos_cap_v2"),
    ("beta_schedule", None), ("prediction_type", "sample"),
    ("timestep_spacing", "trailing"), ("timestep_spacing", "linspace"),
    ("trained_betas", [0.00085, 0.012]), ("clip_sample", True), ("thresholding", True),
    ("rescale_betas_zero_snr", True),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"),
        lambda cell: INVERT_LIMITS if "invert" in cell else EDIT_LIMITS,
        cells=CELLS, configs=CONFIGS)
    shutil.copy(TESTS / "transformer_arch.py", r / "architectures" / "transformer_test.py")
    return r


def _argv(cell: str, seed: int = SEED) -> list:
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"]


def _run(root, cell, capsys) -> dict:
    rc = harness.main(_argv(cell), time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_cell(root, cell: str) -> dict:
    c = manifest.cell(cell, root)
    args = harness.parse(_argv(cell))
    return harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the program's schedule
# ---------------------------------------------------------------------------


def _equal(a: ddim.DDIMSchedule, b: ddim.DDIMSchedule) -> bool:
    return (a.num_train_timesteps == b.num_train_timesteps
            and a.final_alpha_cumprod == b.final_alpha_cumprod
            and np.array_equal(a.alphas_cumprod, b.alphas_cumprod)
            and np.array_equal(a.timesteps, b.timesteps))


def _scheduler(config: str) -> dict:
    return json.loads((BENCH / "configs" / f"{config}.json").read_text())["scheduler"]


EPS_CONFIGS = sorted(p.stem for p in BENCH.glob("configs/*.json")
                     if schedule.prediction_type(_scheduler(p.stem)) == "epsilon")


@pytest.mark.parametrize("config", EPS_CONFIGS)
@pytest.mark.parametrize("steps", [50, 500])
def test_the_cells_configurations_build_the_schedule_the_drivers_built_before(config, steps):
    """Every eps configuration with a cell carries SD's schedule: the
    program's schedule from its scheduler is the port's default one, bit for
    bit."""
    sched = _scheduler(config)
    assert _equal(program.ddim_schedule(sched, steps), ddim.make_schedule(steps))
    assert program.prediction_kw(sched) == {}


# HunyuanDiT v1.2's SDEdit tables at 50 steps cut at 0.9, as the harness
# built them before rectified flow: t = 861, 841, ..., 1 and slots 43..0;
# alpha_t below, alpha_prev the next step's alpha_t and, after the last,
# alphas_cumprod[0] (scaled-linear betas 0.00085 to 0.03)
HUNYUAN_ALPHA_T = [
    0.00023788293765392154, 0.000379516975954175, 0.000594819022808224,
    0.0009161756024695933, 0.0013872886775061488, 0.002065869979560375,
    0.0030264980159699917, 0.004363470710813999, 0.006193419452756643,
    0.008657410740852356, 0.011922200210392475, 0.01618032716214657,
    0.021648701280355453, 0.02856544591486454, 0.037184786051511765,
    0.047769978642463684, 0.06058431789278984, 0.07588055729866028,
    0.09388913959264755, 0.11480583250522614, 0.1387794315814972, 0.16590042412281036,
    0.1961911916732788, 0.22959861159324646, 0.26598963141441345, 0.3051501214504242,
    0.34678733348846436, 0.39053598046302795, 0.43596744537353516, 0.482602059841156,
    0.5299233198165894, 0.5773938894271851, 0.6244720220565796, 0.6706278920173645,
    0.7153590321540833, 0.7582043409347534, 0.7987557053565979, 0.8366671800613403,
    0.8716619610786438, 0.9035358428955078, 0.9321587681770325, 0.9574735164642334,
    0.9794923663139343, 0.9982923269271851,
]
HUNYUAN_FINAL_ALPHA = 0.9991499781608582


@pytest.mark.parametrize("config", ["hunyuandit_v12"])
@pytest.mark.parametrize("steps", [50, 500])
def test_the_v_configuration_s_tables_are_pinned(config, steps):
    """The DiT's scheduler (betas to 0.03, v-prediction) reads the tables
    it read before, the program's schedule and the reference's bit for bit,
    and the program is told v. At 50 steps cut at 0.9 the tables are
    pinned whole; the 500-step grid (cut at 0.9: t = 897, 895, ..., 1)
    holds the same alphas at the 50-step grid's t."""
    sched = _scheduler(config)
    assert sched["beta_end"] == 0.03 and schedule.prediction_type(sched) == "v_prediction"
    traffic = {"timesteps": steps, "save_steps": steps, "start": 0.9}
    tables = schedule.edit_tables(sched, traffic)
    assert tables["prediction_type"] == "v_prediction"
    first = 861 if steps == 50 else 897
    np.testing.assert_array_equal(tables["t"], np.arange(first, 0, -1000 // steps))
    np.testing.assert_array_equal(tables["slot"], np.arange(len(tables["t"]) - 1, -1, -1))
    want = np.asarray(HUNYUAN_ALPHA_T, dtype=np.float32)
    on_50 = np.isin(tables["t"], np.arange(861, 0, -20))
    np.testing.assert_array_equal(tables["alpha_t"][on_50], want)
    if steps == 50:
        np.testing.assert_array_equal(tables["alpha_prev"],
                                      np.append(want[1:], np.float32(HUNYUAN_FINAL_ALPHA)))
    assert tables["alpha_prev"][-1] == np.float32(HUNYUAN_FINAL_ALPHA)
    prog = ddim.truncate_schedule(program.ddim_schedule(sched, steps), 0.9)
    alpha_t, alpha_prev = prog.step_alphas()
    np.testing.assert_array_equal(prog.timesteps, tables["t"])
    np.testing.assert_array_equal(alpha_t, tables["alpha_t"])
    np.testing.assert_array_equal(alpha_prev, tables["alpha_prev"])
    assert program.prediction_kw(sched) == {"prediction_type": "v_prediction"}


@pytest.mark.parametrize("keys", [{"beta_end": 0.03}, {"set_alpha_to_one": True},
                                  {"steps_offset": 0}, {"beta_start": 0.0001,
                                                        "num_train_timesteps": 2000}])
def test_the_program_s_tables_are_the_reference_s(keys):
    """On a scheduler that is not SD's, the program's per-step alphas and
    timesteps equal the reference's tables, for the edit and the inversion."""
    sched = dict(SD21, **keys)
    n = 50
    traffic = {"timesteps": n, "save_steps": n, "inversion_steps": 500}
    prog = program.ddim_schedule(sched, n)
    edit, inv = schedule.edit_tables(sched, traffic), schedule.inversion_tables(sched, traffic)
    alpha_t, alpha_prev = prog.step_alphas()
    assert np.array_equal(prog.timesteps, edit["t"])
    assert np.array_equal(alpha_t, edit["alpha_t"])
    assert np.array_equal(alpha_prev, edit["alpha_prev"])
    inv_t, inv_prev = prog.inversion_alphas()
    assert np.array_equal(inv_t, inv["alpha_t"]) and np.array_equal(inv_prev, inv["alpha_prev"])
    if keys.get("steps_offset", 1) == 1:  # the port's save grid keeps SD's offset
        save = ddim.save_grid(500, n, num_train_timesteps=sched["num_train_timesteps"])[0]
        assert np.array_equal(save, schedule.save_grid(sched, n))


@pytest.mark.parametrize("cell", ["tiny_b03_edit", "tiny_b03_sdedit", "tiny_b03_invert"])
def test_betas_that_end_at_0_03_are_run_by_both_sides(root, cell, capsys):
    result = _run(root, cell, capsys)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny_b03_edit", "tiny_b03_invert"])
def test_the_port_s_default_betas_are_not_correct_there(root, cell, capsys, monkeypatch):
    """The program's schedule on the port's defaults (betas to 0.012), as
    the drivers built it before they read the configuration: the program
    and the reference run different noise levels, and the run is not
    correct. (SDEdit's two tiny steps lie at low noise, where the two
    schedules differ least: its cell reads just over its limit, 0.174.) The
    window holds six steps however slow the machine, so a later step is
    compared: the inversion's first step starts at the final alpha, where
    the two schedules nearly agree."""
    default = ddim.make_schedule
    monkeypatch.setattr(ddim, "make_schedule", lambda steps, **kw: default(steps))
    monkeypatch.setattr(harness, "window", tiny.fixed_window(6))
    result = _run(root, cell, capsys)
    assert result["correct"] is False and result["failed"] >= 1
    state = result["checks"]["state_rel_l2"]
    assert state["value"] > 2 * state["limit"]


# ---------------------------------------------------------------------------
# v-prediction in the reference
# ---------------------------------------------------------------------------


def _exact_model(x0: torch.Tensor, level: dict, prediction: str):
    """A model whose output is the exact eps, or v, of its sample against
    the clean latents ``x0`` (shared by every frame), at the level
    ``level[t]`` the sample sits at."""
    def model(P, sample, t, ctx, edit=None, **kw):
        a = torch.tensor(float(level[int(t)]), dtype=torch.float64)
        s, c = sample.double(), x0.double().expand_as(sample)
        eps = (s - a.sqrt() * c) / (1 - a).sqrt()
        out = eps if prediction == "epsilon" else a.sqrt() * eps - (1 - a).sqrt() * c
        return out.float(), None

    return model


def _noised(x0, eps, a) -> torch.Tensor:
    a = torch.tensor(float(a), dtype=torch.float64)
    return (a.sqrt() * x0.double() + (1 - a).sqrt() * eps.double()).float()


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_one_reference_step_lands_on_the_next_level(prediction):
    """With the exact output of either kind, one edit step from alpha_t and
    one inversion step from alpha_prev land on the other level's noised
    latents to fp32 rounding; read as the other kind, they miss."""
    sched = dict(HUNYUAN_LIKE, prediction_type=prediction)
    traffic = {"timesteps": 10, "save_steps": 10, "guidance_scale": 7.5, "editor": "sdedit"}
    gen = torch.Generator().manual_seed(5)
    f, hw = 4, 8
    x0 = torch.randn((1, hw, hw, 4), generator=gen)
    eps = torch.randn((f, hw, hw, 4), generator=gen)
    embeds3 = torch.randn((3, 77, 32), generator=gen)
    pa, pb, w1 = (torch.as_tensor(a) for a in schedule.propagation_indices(f, 2))
    edit = schedule.edit_tables(sched, traffic)
    inv = schedule.inversion_tables(sched, traffic)
    other = "epsilon" if prediction == "v_prediction" else "v_prediction"
    P = Precision("fp32")
    misread = []

    def edit_at(i, kind):
        model = _exact_model(x0, {int(edit["t"][i]): edit["alpha_t"][i]}, kind)
        x = _noised(x0, eps, edit["alpha_t"][i])  # as the source stream: guidance skips it
        return ref_steps.edit_step(P, model, None, x, x, embeds3, edit, i, [0, 2], traffic,
                                   (frozenset(), None), pa=pa, pb=pb, w1=w1)

    def invert_at(i, kind):
        model = _exact_model(x0, {int(inv["t"][i]): inv["alpha_prev"][i]}, kind)
        return ref_steps.inversion_step(P, model, None, _noised(x0, eps, inv["alpha_prev"][i]),
                                        embeds3[:1], inv, i)

    for step, tables, level_to in ((edit_at, edit, "alpha_prev"), (invert_at, inv, "alpha_t")):
        for i in range(len(tables["t"])):
            want = _noised(x0, eps, tables[level_to][i])
            torch.testing.assert_close(step(i, prediction), want, rtol=2e-5, atol=2e-5)
            misread.append(float((step(i, other) - want).abs().max()))
    assert max(misread) > 0.1


# ---------------------------------------------------------------------------
# what the program is told
# ---------------------------------------------------------------------------

ABSENT = "absent"


@pytest.mark.parametrize("cell,told", [("tiny_v_edit", "v_prediction"),
                                       ("tiny_v_invert", "v_prediction"),
                                       ("tiny_pnp_edit", ABSENT), ("tiny_invert", ABSENT)])
def test_the_program_is_told_the_prediction_type(root, cell, told, monkeypatch):
    """The program's entry of the stage gets ``prediction_type`` where the
    configuration's is not eps, and no such argument where it is (the
    recorder then runs the entry as the configuration's eps)."""
    seen = []

    def recorded(real):
        def entry(*args, **kw):
            seen.append(kw.pop("prediction_type", ABSENT))
            return real(*args, **kw)
        return entry

    if "invert" in cell:
        monkeypatch.setattr(inversion, "ddim_inversion", recorded(inversion.ddim_inversion))
    else:
        monkeypatch.setattr(pipeline, "tokenflow_sample_loop",
                            recorded(pipeline.tokenflow_sample_loop))
    monkeypatch.setattr(harness, "window", tiny.fixed_window(2))
    _run_cell(root, cell)
    assert seen and set(seen) == {told}


@pytest.mark.parametrize("cell", ["tiny_v_edit", "tiny_v_invert"])
def test_a_v_prediction_configuration_runs_only_where_the_program_takes_it(root, cell, capsys,
                                                                          monkeypatch):
    """Where the stage's entry has no ``prediction_type``, the run fails in
    set-up with the program's own TypeError naming it, and never reaches
    the window; where it has one, the run is correct."""
    entry = inversion.ddim_inversion if "invert" in cell else pipeline.tokenflow_sample_loop
    if "prediction_type" in inspect.signature(entry).parameters:
        result = _run(root, cell, capsys)
        assert result["correct"] is True and result["failed"] == 0
        return

    def window(*args, **kw):
        raise AssertionError("the window was reached")

    monkeypatch.setattr(harness, "window", window)
    with pytest.raises(TypeError, match="prediction_type"):
        harness.main(_argv(cell), time.monotonic(), root=root, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,value", REFUSED)
@pytest.mark.parametrize("cell", ["tiny_pnp_edit", "tiny_invert"])
def test_a_scheduler_the_reference_does_not_follow_is_refused_by_name(root, cell, key, value,
                                                                      monkeypatch):
    """Refused in the stage's set-up, naming the key and the value, before
    the program's model is built."""
    c = manifest.cell(cell, root)
    c.config["scheduler"] = dict(c.config["scheduler"], **{key: value})

    def program_model(*args, **kw):
        raise AssertionError("the program's model was built")

    monkeypatch.setattr(c.arch, "program_model", program_model)
    args = harness.parse(_argv(cell))
    with pytest.raises(ValueError, match=re.escape(f"scheduler {key}={value!r}")):
        harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"))


@pytest.mark.parametrize("keys", [{}, {"timestep_spacing": "leading"},
                                  {"prediction_type": "v_prediction"},
                                  {"prediction_type": None, "clip_sample": None},
                                  {"set_alpha_to_one": True, "steps_offset": 0},
                                  {"trained_betas": None, "thresholding": False,
                                   "rescale_betas_zero_snr": False}])
def test_the_followed_values_pass(keys):
    sched = {k: v for k, v in dict(SD21, **keys).items() if v is not None}
    schedule.check(sched)
    want = "v_prediction" if keys.get("prediction_type") == "v_prediction" else "epsilon"
    assert schedule.prediction_type(sched) == want
    assert program.prediction_kw(sched) == ({} if want == "epsilon" else
                                            {"prediction_type": want})


# ---------------------------------------------------------------------------
# the denoiser's group
# ---------------------------------------------------------------------------


def test_the_architecture_names_the_denoiser_s_group(root):
    assert manifest.cell("tiny_dit_edit", root).denoiser_group == "transformer"
    assert manifest.cell("tiny_pnp_edit", root).denoiser_group == manifest.DEFAULT_DENOISER_GROUP
    for cell in ("sd21_pnp512_edit", "sdxl_sdedit1024_edit"):
        assert manifest.cell(cell).denoiser_group == "unet"


@pytest.mark.parametrize("cell", ["tiny_dit_edit", "tiny_dit_invert"])
def test_a_denoiser_under_its_own_group_runs_through_the_harness(root, cell, capsys):
    """The configuration holds the denoiser under "transformer" and a null
    "unet": the weights and the reference come from the module's group."""
    c = manifest.cell(cell, root)
    assert c.config["unet"] is None and c.config["transformer"] == tiny.TINY_UNET
    result = _run(root, cell, capsys)
    assert result["correct"] is True and result["failed"] == 0

"""The HunyuanDiT architecture (``architectures/hunyuan_dit.py``,
``reference/hunyuan_dit.py``): its operation count against PyTorch's FLOP
counter on the reference at tiny shapes and pinned on the cell, the spec
read from the configuration, the refusals by key, a tiny DiT SDEdit cell and
a tiny inversion cell through the harness on the CPU (correct; the SDEdit
cell's fp8 control not), and ``scripts/bench_sites.py`` on the SDEdit cell,
whose denoiser group is "transformer".

The tiny cells' limits: on the CPU both sides run fp32, so the sound runs
read about 1e-6; the edit's lie far below the fp8 control's first compared
step (0.27 state, 0.29 worst frame at this seed), and the inversion's are
the tiny inversion cells' (``test_benchmark_schedule.py``)."""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests"),
                str(BENCH.parent / "scripts")]

import bench_sites  # noqa: E402
import harness  # noqa: E402
import manifest  # noqa: E402
import tiny  # noqa: E402
import weights  # noqa: E402
import yardstick as Y  # noqa: E402
from reference import hunyuan_dit as R  # noqa: E402
from reference import schedule  # noqa: E402
from reference.precision import Precision  # noqa: E402
from reference.steps import edit_step, inversion_step  # noqa: E402

DIT = manifest.architecture("hunyuan_dit")
CONFIG = json.loads((BENCH / "configs" / "hunyuandit_v12.json").read_text())
SCHEDULER = CONFIG["scheduler"]
# the port's tiny_dit preset as a transformer/config.json (the code's pool
# heads, sinusoids and RoPE base stated, as a test config may)
TINY_DIT = {
    "activation_fn": "gelu-approximate", "cross_attention_dim": 32,
    "cross_attention_dim_t5": 16, "hidden_size": 32, "in_channels": 4, "learn_sigma": True,
    "mlp_ratio": 2.0, "norm_type": "layer_norm", "num_attention_heads": 2, "num_layers": 6,
    "patch_size": 2, "pooled_projection_dim": 24, "sample_size": 8, "text_len": 77,
    "text_len_t5": 16, "use_style_cond_and_image_meta_size": False, "pool_heads": 2,
    "time_proj_dim": 32, "rope_base": 2,
}
CELLS = {"tiny_dit_sdedit_edit": ("tiny_hdit", "tiny_sdedit"),
         "tiny_dit_invert": ("tiny_hdit", "tiny_invert")}
EDIT_LIMITS = {"state_rel_l2": 0.05, "frame_rel_l2": 0.05}
INVERT_LIMITS = {"state_rel_l2": 0.015, "frame_rel_l2": 0.018, "slot_gap": 0.0,
                 "slots_wrong": 0.0}
SEED = 3000000026


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"),
        lambda cell: INVERT_LIMITS if "invert" in cell else EDIT_LIMITS, cells=CELLS,
        configs={"tiny_hdit": {"transformer": TINY_DIT, "unet": None,
                               "architecture": "hunyuan_dit", "scheduler": SCHEDULER}})


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("stage", ["edit", "invert"])
def test_step_flops_match_the_flop_counter_on_the_reference(stage):
    """A tiny step of each stage through the DiT reference, counted by
    FlopCounterMode, against the architecture's count of the same step: the
    patch convolution, the conditioning, the pool, the text projection,
    every block's linears (the long skips' among them), attention products
    and matches, and the output."""
    cfg = {"transformer": TINY_DIT}
    traffic = copy.deepcopy(tiny.TINY_TRAFFIC["tiny_sdedit" if stage == "edit"
                                              else "tiny_invert"])
    spec, cn = DIT.specs(cfg)
    shapes = DIT.reference_model("unet", TINY_DIT)
    dit = DIT.reference_model("unet", TINY_DIT, weights.random_state_dict(
        shapes, 7, "cpu", torch.float32))
    f, hw = traffic["frames"], traffic["resolution"] // 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((f, hw, hw, 4), generator=gen)
    P = Precision("fp32")
    if stage == "edit":
        _, kw = DIT.model_inputs(spec, 3, 5, "cpu", torch.float32)
        tables = schedule.edit_tables(SCHEDULER, traffic)
        pa, pb, w1 = (torch.as_tensor(a) for a in
                      schedule.propagation_indices(f, traffic["window"]))
        embeds = torch.randn((3, 77, 32), generator=gen)
        counted = _counted(lambda: edit_step(P, dit, None, x, x, embeds, tables, 0, [1, 2],
                                             traffic, DIT.inject_sites(spec), pa=pa, pb=pb,
                                             w1=w1, model_kw=kw))
    else:
        _, kw = DIT.model_inputs(spec, 1, 5, "cpu", torch.float32)
        tables = schedule.inversion_tables(SCHEDULER, traffic)
        counted = _counted(lambda: inversion_step(P, dit, None, x, torch.randn((1, 77, 32)),
                                                  tables, 0, model_kw=kw))
    assert Y.flops(DIT.step_ops(stage, spec, cn, traffic)) == counted


def test_the_cell_counts_eighty_k1_and_k6_calls_and_forty_matches():
    """``hunyuandit_sdedit1024_edit``: K1 runs 80 times a step (40 extended
    at 2 x 20480^2, 40 source calls at 5 x 4096^2, 16 heads of 88), K6 80
    times (the 333-key cross attention of both passes), the match core 40
    times at 4096 tokens 1408 wide; about 1.5 PFLOP a step."""
    c = manifest.cell("hunyuandit_sdedit1024_edit")
    spec, cn = c.arch.specs(c.config)
    ops = c.arch.step_ops(c.stage, spec, cn, c.traffic)
    attn = [o for o in ops if isinstance(o, Y.Attn)]
    k1 = [(o.b, o.h, o.sq, o.skv, o.d) for o in attn if o.k1]
    assert (k1.count((2, 16, 20480, 20480, 88)), k1.count((5, 16, 4096, 4096, 88)),
            len(k1)) == (40, 40, 80)
    k6 = [(o.b, o.h, o.sq, o.skv, o.d) for o in attn if not o.k1]
    assert (k6.count((15, 16, 4096, 333, 88)), k6.count((120, 16, 4096, 333, 88)),
            len(k6)) == (40, 40, 80)
    matches = [o for o in ops if isinstance(o, Y.Match)]
    assert len(matches) == 40 and {(m.f, m.s, m.c, m.k, m.ns) for m in matches} == {
        (40, 4096, 1408, 5, 3)}
    assert 1.4e15 < Y.flops(ops) < 1.6e15


def test_the_spec_is_read_from_the_configuration():
    spec, cn = DIT.specs(CONFIG)
    assert cn is None
    assert (spec.hidden_size, spec.num_layers, spec.heads, spec.head_dim, spec.ff_inner,
            spec.out_channels, spec.cross_attention_dim, spec.cross_attention_dim_t5,
            spec.pooled_projection_dim, spec.context_len, spec.rope_base) == (
        1408, 40, 16, 88, 6144, 8, 1024, 2048, 1024, 333, 32)
    assert manifest.cell("hunyuandit_sdedit1024_edit").denoiser_group == "transformer"
    ref = DIT.reference_model("unet", CONFIG["transformer"])
    assert sum(p.numel() for p in ref.parameters()) == 1499952032


@pytest.mark.parametrize("key,value", [("use_style_cond_and_image_meta_size", True),
                                       ("learn_sigma", False), ("norm_type", "ada_norm"),
                                       ("activation_fn", "geglu")])
def test_a_config_the_reference_does_not_follow_is_refused_by_key(key, value):
    cfg = copy.deepcopy(CONFIG)
    cfg["transformer"][key] = value
    with pytest.raises(ValueError, match=f"config {key}="):
        DIT.specs(cfg)


def test_a_controlnet_and_pnp_are_refused():
    cfg = dict(CONFIG, controlnet={"in_channels": 4})
    with pytest.raises(ValueError, match="no ControlNet"):
        DIT.specs(cfg)
    ref = DIT.reference_model("unet", TINY_DIT, weights.random_state_dict(
        DIT.reference_model("unet", TINY_DIT), 3, "cpu", torch.float32))
    spec, _ = DIT.specs({"transformer": TINY_DIT})
    _, kw = DIT.model_inputs(spec, 3, 5, "cpu", torch.float32)
    x = torch.zeros((3, 8, 8, 4))
    with pytest.raises(ValueError, match="PnP is not defined"):
        ref(Precision("fp32"), x, 1, torch.zeros((3, 77, 32)),
            edit=R.M.Edit("pivotal", 1, 3, pnp=True), **kw)


def test_model_inputs_come_from_the_seed():
    spec, _ = DIT.specs(CONFIG)
    a, ra = DIT.model_inputs(spec, 3, 11, "cpu", torch.bfloat16)
    b, _ = DIT.model_inputs(spec, 3, 11, "cpu", torch.bfloat16)
    c, _ = DIT.model_inputs(spec, 3, 12, "cpu", torch.bfloat16)
    got = a["added_cond"]
    assert got["encoder_hidden_states_t5"].shape == (3, 256, 2048)
    assert got["text_embedding_mask"].shape == (3, 77)
    assert got["text_embedding_mask_t5"].shape == (3, 256)
    for k, v in got.items():
        assert torch.equal(v, b["added_cond"][k])
    assert not torch.equal(got["encoder_hidden_states_t5"],
                           c["added_cond"]["encoder_hidden_states_t5"])
    assert torch.equal(ra["mask"], got["text_embedding_mask"])
    # each mask is ones, then zeros, and keeps at least one token
    for m in (got["text_embedding_mask"], got["text_embedding_mask_t5"]):
        assert (m[:, 0] == 1).all() and (m[:, 1:] <= m[:, :-1]).all()


def _run(root, cell, capsys) -> dict:
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0.5", "--trace", "0"]
    rc = harness.main(argv, time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_dit_cells_run_through_the_harness(root, cell, capsys, monkeypatch):
    """The program's DiT (v-prediction through the port's loop and
    inversion) against the reference: correct."""
    monkeypatch.setattr(harness, "window", tiny.fixed_window(2))
    result = _run(root, cell, capsys)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]


def test_the_fp8_control_is_not_correct_on_the_tiny_edit_cell(root, monkeypatch):
    monkeypatch.setattr(harness, "window", tiny.fixed_window(2))
    cell = "tiny_dit_sdedit_edit"
    c = manifest.cell(cell, root)
    args = harness.parse(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5"])
    out = harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"),
                           control="fp8")
    correct, failed, checked = harness.decide(c, out["control"])
    assert not correct and failed >= 1, out["control"]
    assert all(v > EDIT_LIMITS[n] for n, (v, _) in checked.items())


def test_bench_sites_runs_a_transformer_cell(root, capsys, monkeypatch):
    """``scripts/bench_sites.py`` reads the configuration's denoiser group
    ("transformer"): on the CPU its host numbers, one edit site a block (6
    a tiny DiT call, two calls a step) and the pivotal caches' bytes."""
    monkeypatch.setattr(harness, "window", tiny.fixed_window(2))
    argv = ["--workload", "tiny_dit_sdedit_edit", "--seed", str(SEED), "--seconds", "0.5"]
    assert bench_sites.main(argv, root=root, device=torch.device("cpu")) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counters = out["edit_counters"]
    assert counters["per_unet_call"]["sites_visited"] == 6
    assert counters["per_step"]["sites_visited"] == 12
    assert counters["per_step"]["pivotal_cache_bytes"] > 0
    assert out["norm_launches"]["per_step"]["dit_calls"] == 2

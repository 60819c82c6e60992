"""The SD-XL architecture (``architectures/sdxl.py``, ``reference/sdxl.py``):
its operation count against PyTorch's FLOP counter on the reference at tiny
shapes and pinned on the cell, a tiny SD-XL SDEdit cell through the harness
on the CPU (correct; its fp8 control not), ``scripts/bench_sites.py`` on that
cell with the specs and weights from the architecture module, and the PnP
and ControlNet refusals.

The tiny cell's limits are its own, set as the cells' are (PERF.md): over
seeds 1-6 sound runs read at most 0.116 (state) and 0.186 (worst frame),
the fp8 control at least 0.471 and 0.535 on the first compared step."""

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
from reference import model as M  # noqa: E402
from reference import schedule  # noqa: E402
from reference.precision import Precision  # noqa: E402
from reference.steps import edit_step, inversion_step  # noqa: E402

XL = manifest.architecture("sdxl")
SCHEDULER = json.loads((BENCH / "configs" / "sdxl.json").read_text())["scheduler"]
TINY_XL_UNET = {
    "act_fn": "silu", "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "attention_head_dim": [2, 2, 4], "block_out_channels": [32, 64, 64],
    "cross_attention_dim": 32,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4, "layers_per_block": 1,
    "norm_eps": 1e-05, "norm_num_groups": 32, "out_channels": 4,
    "projection_class_embeddings_input_dim": 32 + 6 * 8, "sample_size": 8,
    "transformer_layers_per_block": [1, 2, 3],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "use_linear_projection": True,
}
CELL = "tiny_xl_sdedit_edit"
LIMITS = {"state_rel_l2": 0.3, "frame_rel_l2": 0.35}
SEED = 3000000021
# edit sites a tiny SD-XL call visits: down_1_0 (2 blocks), down_2_0 (3), mid
# (3), up_0_{0,1} (3 each), up_1_{0,1} (2 each)
TINY_SITES = 18


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy_with_tiny_cells(
        tmp_path_factory.mktemp("bench"), lambda cell: LIMITS,
        cells={CELL: ("tiny_xl", "tiny_sdedit")},
        configs={"tiny_xl": {"unet": TINY_XL_UNET, "architecture": "sdxl",
                             "scheduler": SCHEDULER}})


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("stage", ["edit", "invert"])
def test_step_flops_match_the_flop_counter_on_the_reference(stage):
    """A tiny step of each stage through the SD-XL reference, counted by
    FlopCounterMode, against the architecture's count of the same step:
    70 blocks' worth of sites at full size, 18 here, the attention-free
    level and the add embedding's two linear layers included."""
    cfg = {"unet": TINY_XL_UNET}
    traffic = copy.deepcopy(tiny.TINY_TRAFFIC["tiny_sdedit" if stage == "edit"
                                              else "tiny_invert"])
    spec, cn = XL.specs(cfg)
    shapes = XL.reference_model("unet", cfg["unet"])
    unet = XL.reference_model("unet", cfg["unet"], weights.random_state_dict(
        shapes, 7, "cpu", torch.float32))
    f, hw = traffic["frames"], traffic["resolution"] // 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((f, hw, hw, 4), generator=gen)
    P = Precision("fp32")
    if stage == "edit":
        _, kw = XL.model_inputs(spec, 3, 5, "cpu", torch.float32)
        tables = schedule.edit_tables(SCHEDULER, traffic)
        pa, pb, w1 = (torch.as_tensor(a) for a in
                      schedule.propagation_indices(f, traffic["window"]))
        embeds = torch.randn((3, 77, 32), generator=gen)
        counted = _counted(lambda: edit_step(P, unet, None, x, x, embeds, tables, 0, [1, 2],
                                             traffic, XL.inject_sites(spec), pa=pa, pb=pb,
                                             w1=w1, model_kw=kw))
    else:
        _, kw = XL.model_inputs(spec, 1, 5, "cpu", torch.float32)
        tables = schedule.inversion_tables(SCHEDULER, traffic)
        counted = _counted(lambda: inversion_step(P, unet, None, x, torch.randn((1, 77, 32)),
                                                  tables, 0, model_kw=kw))
    assert Y.flops(XL.step_ops(stage, spec, cn, traffic)) == counted


def test_the_cell_counts_seventy_sites_and_eighty_k1_calls():
    """``sdxl_sdedit1024_edit``: one step is 7.6996e14 FLOPs; K1 runs 80
    times (10 extended at 2 x 20480^2 with 10 heads, 60 at 2 x 5120^2 with
    20, 10 source calls at 5 x 4096^2) and the match core 70 times, one per
    block; the 32^2 sources' 1024 keys take the short-key path."""
    c = manifest.cell("sdxl_sdedit1024_edit")
    ops = c.arch.step_ops(c.stage, *c.arch.specs(c.config), c.traffic)
    assert len(ops) == 1378
    assert Y.flops(ops) == 769959251148800.0
    k1 = [(o.b, o.h, o.sq, o.skv) for o in ops if isinstance(o, Y.Attn) and o.k1]
    assert (k1.count((2, 10, 20480, 20480)), k1.count((2, 20, 5120, 5120)),
            k1.count((5, 10, 4096, 4096)), len(k1)) == (10, 60, 10, 80)
    assert sum(isinstance(o, Y.Match) for o in ops) == 70


def test_the_reference_loads_the_published_layout_and_refuses_pnp_and_residuals():
    """Full size on the meta device: 2.5675 B parameters under diffusers'
    key names, the port's UNet the same names and shapes; the reference
    refuses a PnP edit and ControlNet residuals, the module a ControlNet."""
    c = manifest.cell("sdxl_sdedit1024_edit")
    ref = c.arch.reference_model("unet", c.config["unet"])
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert sum(v.numel() for v in ref.parameters()) == 2567463684
    assert "add_embedding.linear_1.weight" in shapes
    assert shapes["add_embedding.linear_1.weight"] == (1280, 2816)
    assert len(ref.mid_block.attentions[0].transformer_blocks) == 10
    port = c.arch.program_model("unet", c.arch.specs(c.config)[0],
                                {k: torch.empty(s, device="meta") for k, s in shapes.items()})
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == shapes

    spec, _ = XL.specs({"unet": TINY_XL_UNET})
    unet = XL.reference_model("unet", TINY_XL_UNET, weights.random_state_dict(
        XL.reference_model("unet", TINY_XL_UNET), 7, "cpu", torch.float32))
    _, kw = XL.model_inputs(spec, 3, 5, "cpu", torch.float32)
    x = torch.randn((3, 8, 8, 4))
    ctx = torch.randn((3, 77, 32))
    with pytest.raises(ValueError, match="PnP is not defined on SD-XL"):
        unet(Precision("fp32"), x, 1, ctx, M.Edit("pivotal", 1, 3, pnp=True), **kw)
    with pytest.raises(ValueError, match="no SD-XL ControlNet"):
        unet(Precision("fp32"), x, 1, ctx, None, (x,), x, **kw)
    with pytest.raises(ValueError, match="no ControlNet"):
        XL.specs({"unet": TINY_XL_UNET, "controlnet": TINY_XL_UNET})
    with pytest.raises(ValueError, match="addition_embed_type"):
        XL.specs({"unet": dict(TINY_XL_UNET, addition_embed_type="text")})
    assert XL.inject_sites(spec) == (frozenset(), None)


def test_a_tiny_sdxl_edit_cell_is_correct_and_its_fp8_control_is_not(root, monkeypatch,
                                                                    capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                       "--trace", "0"], time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == set(LIMITS)

    monkeypatch.setattr(harness, "window", tiny.fixed_window(4))
    c = manifest.cell(CELL, root)
    args = harness.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5"])
    out = harness.run_cell(c, args, time.monotonic(), root, torch.device("cpu"), control="fp8")
    assert harness.decide(c, out["compared"])[0] is True
    correct, failed, checked = harness.decide(c, out["control"])
    assert correct is False and failed >= 1
    assert checked["state_rel_l2"][0] > checked["state_rel_l2"][1]


def test_bench_sites_takes_the_architecture_from_the_cell(root, capsys):
    """``scripts/bench_sites.py`` on the tiny SD-XL cell: the spec, weights
    and models from ``architectures/sdxl.py``; every UNet call visits its
    18 edit sites, and the pivotal calls return their caches' bytes."""
    rc = bench_sites.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3"],
                          root=root, device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "cpu" and out["steps"]["spans_on"] >= 1
    counters = out["edit_counters"]
    assert counters["unet_calls"] == 2 * out["steps"]["spans_on"]
    assert counters["per_unet_call"]["sites_visited"] == TINY_SITES
    # a step's pivotal cache: every block's pivot_h (K, S, C) and three-stream
    # kf_attn, K = 2 pivots, bf16; 4^2 tokens x 64 at level 1's 6 blocks,
    # 2^2 at level 2's 12
    per_step = 4 * 2 * 2 * ((2 + 4) * 4 * 4 * 64 + (3 + 3 + 6) * 2 * 2 * 64)
    assert counters["per_step"]["pivotal_cache_bytes"] == per_step

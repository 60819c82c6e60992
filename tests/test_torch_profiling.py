"""The port's program spans (``tokenflow_torch/profiling.py``).

- Off, ``span`` is one shared no-op and nothing is recorded.
- On (``profiling.spans``), a tiny edit step (two passes and fused), a
  ControlNet edit step, the per-frame SDEdit loop and inversion and
  reconstruction steps record the expected names and nesting, each span
  with its parent and its step's index.
- Spans on or off, the edit and the inversion give bitwise-equal outputs.
- Under ``torch.profiler`` on the CPU the ``tf.*`` names are events;
  ``profiling.trace`` turns the spans on; ``device_phase`` still fills
  ``PhaseMetrics`` under the phase's name.
"""

import json
import os

import numpy as np
import pytest
import torch

from tokenflow_torch import profiling
from tokenflow_torch.cli import common as tcommon
from tokenflow_torch.diffusion import ddim, inversion
from tokenflow_torch.editing import pipeline
from tokenflow_torch.models import controlnet as tcn
from tokenflow_torch.models import unet2d

torch.set_num_threads(2)

HW, F, WS, STEPS = 8, 4, 2, 2  # latent size, frames, window (2 pivots), steps
PIVOTS = np.asarray([[1, 2], [0, 3]], np.int32)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = unet2d.UNet2DConfig.tiny()
    unet = unet2d.UNet2DConditionModel(cfg).eval()
    cn = tcn.ControlNetModel(cfg, cond_downsamples=3).eval()
    gen = torch.Generator().manual_seed(1)
    data = {
        "x0": torch.randn(F, HW, HW, 4, generator=gen),
        "embeds3": torch.randn(3, 7, 32, generator=gen),
        "traj": torch.randn(STEPS, F, HW, HW, 4, generator=gen) * 0.8,
        "cond": torch.rand(F, 8 * HW, 8 * HW, 3, generator=gen),
    }
    return unet, cn, data


def _edit(tiny, **kw):
    unet, cn, data = tiny
    sched = ddim.make_schedule(STEPS)
    extra = {}
    if kw.pop("controlnet", False):
        extra = dict(controlnet_fn=cn, cond_image=data["cond"])
    return pipeline.tokenflow_sample_loop(
        unet, data["x0"], data["traj"], data["embeds3"],
        pipeline.make_edit_schedule(sched, sched.timesteps[::-1].copy(),
                                    pnp_attn_t=0.5, pnp_f_t=0.8),
        window_size=WS, guidance_scale=7.5, pnp=True, pivot_indices=PIVOTS, **extra, **kw)


def _vanilla(tiny):
    unet, _, data = tiny
    sched = ddim.make_schedule(STEPS)
    return pipeline.vanilla_sample_loop(
        unet, data["x0"], data["embeds3"][1:],
        pipeline.make_edit_schedule(sched, sched.timesteps[::-1].copy()), guidance_scale=7.5)


def _eps_fn(unet, data):
    ctx = data["embeds3"][:1].expand(F, -1, -1)
    return lambda x, t: unet(x, t, ctx)[0]


def _invert(tiny):
    unet, _, data = tiny
    sched = ddim.make_schedule(STEPS)
    eps_fn = _eps_fn(unet, data)
    x, traj, _ = inversion.ddim_inversion(eps_fn, data["x0"], sched, STEPS)
    return torch.cat([x[None], traj, inversion.ddim_reconstruction(eps_fn, x, sched)[None]])


RUNS = {
    "two_pass": lambda tiny: _edit(tiny),
    "fused": lambda tiny: _edit(tiny, fused=True),
    "controlnet": lambda tiny: _edit(tiny, controlnet=True),
    "vanilla": _vanilla,
    "inversion": _invert,
}


def _recorded(tiny, run):
    with profiling.spans() as record:
        out = RUNS[run](tiny)
    return out, record


def _path(record, i) -> list:
    """The names from the top span down to span ``i``."""
    names = []
    while i >= 0:
        names.append(record.spans[i].name)
        i = record.spans[i].parent
    return names[::-1]


def _paths(record) -> set:
    return {tuple(_path(record, i)) for i in range(len(record.spans))}


def test_spans_off_are_one_shared_no_op():
    assert profiling.span("tf.step") is profiling.span("tf.unet")
    with profiling.span("tf.step") as inner:
        assert inner is None
    assert profiling._record is None


def test_spans_record_names_parents_and_steps():
    with profiling.spans() as record:
        for _ in range(2):
            with profiling.span("tf.step"):
                with profiling.span("tf.unet"):
                    with profiling.span("tf.norm"):
                        pass
                with profiling.span("tf.ddim"):
                    pass
        with profiling.span("outside"):
            pass
    assert profiling.span("tf.step") is profiling.span("tf.norm")  # off again
    got = [(s.name, s.parent, s.step) for s in record.spans]
    assert got == [("tf.step", -1, 0), ("tf.unet", 0, 0), ("tf.norm", 1, 0), ("tf.ddim", 0, 0),
                   ("tf.step", -1, 1), ("tf.unet", 4, 1), ("tf.norm", 5, 1), ("tf.ddim", 4, 1),
                   ("outside", -1, -1)]
    assert record.steps == 2
    for s in record.spans:
        assert 0 <= s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = record.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert record.seconds("tf.step") >= record.seconds("tf.unet") > 0


def test_nested_spans_blocks_share_one_record():
    with profiling.spans() as outer:
        with profiling.spans() as inner:
            with profiling.span("tf.step"):
                pass
        assert inner is outer
        with profiling.span("tf.ddim"):  # still on after the inner block
            pass
    assert [s.name for s in outer.spans] == ["tf.step", "tf.ddim"]
    assert profiling._record is None


def test_a_span_closes_on_an_exception():
    with profiling.spans() as record:
        with pytest.raises(ValueError):
            with profiling.span("tf.step"):
                with profiling.span("tf.unet"):
                    raise ValueError("inside")
        with profiling.span("tf.ddim"):
            pass
    assert [(s.name, s.parent) for s in record.spans] == [
        ("tf.step", -1), ("tf.unet", 0), ("tf.ddim", -1)]
    assert all(s.t1_ns >= s.t0_ns for s in record.spans)


def test_two_pass_edit_spans(tiny):
    """tf.step > tf.pivotal > tf.unet > tf.transformer:down_0_0 > tf.norm,
    tf.ext_attn > tf.sdp; the propagation pass's blocks propagate."""
    _, record = _recorded(tiny, "two_pass")
    assert record.steps == STEPS
    assert [s.name for s in record.spans if s.parent == -1] == ["tf.step"] * STEPS
    paths = _paths(record)
    piv = ("tf.step", "tf.pivotal", "tf.unet", "tf.transformer:down_0_0")
    for tail in (("tf.norm",), ("tf.ext_attn",), ("tf.ext_attn", "tf.sdp"),
                 ("tf.cross_attn", "tf.sdp"), ("tf.cross_attn", "tf.norm"), ("tf.ff", "tf.norm")):
        assert piv + tail in paths, tail
    prop = ("tf.step", "tf.propagate", "tf.unet")
    assert prop + ("tf.transformer:up_1_0", "tf.propagation") in paths
    assert prop + ("tf.resnet:up_1_res_1", "tf.norm") in paths
    assert ("tf.step", "tf.propagate", "tf.ddim") in paths
    for kind in ("tf.self_attn", "tf.fused", "tf.controlnet"):
        assert not any(kind in p for p in paths), kind
    names = {s.name for s in record.spans}
    sites = {"tf.resnet:down_0_res_0", "tf.resnet:down_1_res_0", "tf.resnet:mid_res_0",
             "tf.resnet:mid_res_1", "tf.transformer:mid", "tf.resnet:up_0_res_1"}
    assert sites <= names
    # every span inside a step carries that step's index
    for i, s in enumerate(record.spans):
        top = i
        while record.spans[top].parent >= 0:
            top = record.spans[top].parent
        assert s.step == [j for j, t in enumerate(record.spans)
                          if t.name == "tf.step"].index(top)
    # one pivotal and one propagate UNet call a step, each with one tf.unet
    unets = [_path(record, i)[1] for i, s in enumerate(record.spans) if s.name == "tf.unet"]
    assert unets == ["tf.pivotal", "tf.propagate"] * STEPS


def test_fused_edit_spans(tiny):
    _, record = _recorded(tiny, "fused")
    paths = _paths(record)
    site = ("tf.step", "tf.fused", "tf.unet", "tf.transformer:down_0_0")
    assert site + ("tf.ext_attn", "tf.sdp") in paths
    assert site + ("tf.propagation",) in paths
    assert ("tf.step", "tf.fused", "tf.ddim") in paths
    assert not any("tf.pivotal" in p or "tf.propagate" in p for p in paths)
    assert record.steps == STEPS


def test_controlnet_edit_spans(tiny):
    """The ControlNet's encoder half takes the UNet's site names."""
    _, record = _recorded(tiny, "controlnet")
    paths = _paths(record)
    for phase in ("tf.pivotal", "tf.propagate"):
        cn = ("tf.step", phase, "tf.controlnet")
        assert cn + ("tf.transformer:down_0_0", "tf.self_attn", "tf.sdp") in paths
        assert cn + ("tf.resnet:mid_res_1", "tf.norm") in paths
        assert ("tf.step", phase, "tf.unet") in paths


def test_vanilla_and_inversion_spans(tiny):
    _, record = _recorded(tiny, "vanilla")
    assert record.steps == STEPS
    assert ("tf.step", "tf.unet", "tf.transformer:up_1_0", "tf.self_attn", "tf.sdp") in \
        _paths(record)
    _, record = _recorded(tiny, "inversion")
    assert record.steps == 2 * STEPS  # inversion and reconstruction
    paths = _paths(record)
    for tail in (("tf.unet", "tf.resnet:down_0_res_0", "tf.norm"),
                 ("tf.unet", "tf.transformer:down_0_0", "tf.self_attn", "tf.sdp"),
                 ("tf.ddim",)):
        assert ("tf.step",) + tail in paths, tail
    assert [s.step for s in record.spans if s.name == "tf.ddim"] == list(range(2 * STEPS))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_leave_outputs_bitwise_equal(tiny, run):
    off = RUNS[run](tiny)
    assert profiling._record is None
    on, record = _recorded(tiny, run)
    assert record.steps > 0
    assert torch.equal(on, off)


def test_span_names_are_profiler_events(tiny):
    """On, a running profiler sees every tf.* span; off, none."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.spans() as record, profile(activities=[ProfilerActivity.CPU]) as prof:
        _edit(tiny)
    events = [e.name for e in prof.events()]
    want = {s.name for s in record.spans}
    assert {"tf.step", "tf.pivotal", "tf.propagate", "tf.unet", "tf.norm", "tf.sdp",
            "tf.ext_attn", "tf.propagation", "tf.transformer:down_0_0"} <= want
    assert want <= set(events)
    assert events.count("tf.step") == STEPS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _edit(tiny)
    assert not [e.name for e in prof.events() if e.name.startswith("tf.")]


def test_trace_turns_spans_on(tiny, tmp_path):
    trace_dir = str(tmp_path / "trace")
    with profiling.trace(trace_dir):
        assert profiling._record is not None
        _invert(tiny)
    assert profiling._record is None
    (path,) = [os.path.join(trace_dir, p) for p in os.listdir(trace_dir)]
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert names.count("tf.step") == 2 * STEPS and "tf.transformer:mid" in names


def test_device_phase_fills_phase_metrics():
    """The CLIs' phases keep their names in PhaseMetrics, and are spans of
    that name while spans are on."""
    from torch.profiler import ProfilerActivity, profile

    metrics = profiling.PhaseMetrics()
    cpu = torch.device("cpu")
    with tcommon.device_phase(metrics, "edit_pivotal", cpu):
        torch.ones(8).sum()
    with profiling.spans() as record, profile(activities=[ProfilerActivity.CPU]) as prof:
        with tcommon.device_phase(metrics, "edit_pivotal", cpu):
            torch.ones(8).sum()
        with tcommon.device_phase(metrics, "decode", cpu):
            pass
    assert set(metrics.report()["phases_seconds"]) == {"edit_pivotal", "decode"}
    assert [s.name for s in record.spans] == ["edit_pivotal", "decode"]
    assert {"edit_pivotal", "decode"} <= {e.name for e in prof.events()}

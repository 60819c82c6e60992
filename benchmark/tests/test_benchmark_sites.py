"""``sites.py``: device time charged to the program span that launched it,
blocking calls, coverage; and ``scripts/bench_sites.py`` on a tiny cell on
the CPU, where only the host numbers can be read, while the harness's own
windows record no span."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests"),
                str(BENCH.parent / "scripts")]

import bench_sites  # noqa: E402
import harness  # noqa: E402
import sites  # noqa: E402
import tiny  # noqa: E402
from sites import Event  # noqa: E402
from tokenflow_torch import profiling  # noqa: E402

SEED = 3000000021


def _launch(t, corr, name="cudaLaunchKernel"):
    return Event("runtime", name, t, t + 5, corr)


def _events():
    """Two steps, 1000 ns each: tf.step > tf.unet > (tf.norm,
    tf.transformer:down_0_0 > tf.sdp); device work runs later than its
    launch, as it does on a card."""
    ev = [Event("window", "bench.window", 0, 5000)]
    for k, base in enumerate((100, 1100)):
        c = 10 * k
        ev += [
            Event("span", "tf.step", base, base + 900),
            Event("span", "tf.unet", base + 10, base + 800),
            Event("span", "tf.norm", base + 100, base + 200),
            Event("span", "tf.transformer:down_0_0", base + 300, base + 700),
            Event("span", "tf.sdp", base + 400, base + 500),
            _launch(base + 150, c + 1),  # in tf.norm
            Event("device", "vectorized_elementwise_kernel", 3000 + c, 3010 + c, c + 1),
            _launch(base + 450, c + 2),  # in tf.sdp
            Event("device", "copy_kernel", 3020 + c, 3050 + c, c + 2),
            _launch(base + 350, c + 3),  # in the transformer site itself
            Event("device", "sm90_xmma_gemm", 3100 + c, 3200 + c, c + 3),
            _launch(base + 750, c + 4),  # in tf.unet
            Event("device", "cudnn_conv_kernel", 3300 + c, 3340 + c, c + 4),
            _launch(base + 600, c + 5, "cudaMemcpyAsync"),
            Event("device", "Memcpy DtoH (Device -> Pageable)", 3400 + c, 3402 + c, c + 5),
            _launch(base + 610, c + 6, "cudaStreamSynchronize"),
            _launch(base + 620, c + 7, "cudaMemcpyAsync"),  # host to device: not blocking
            Event("device", "Memcpy HtoD (Pageable -> Device)", 3410 + c, 3411 + c, c + 7),
        ]
    ev += [
        _launch(2050, 99),  # outside every span
        Event("device", "memset_kernel", 3500, 3506, 99),
        Event("device", "stray_kernel", 3600, 3604, 0),  # no launch in the trace
        _launch(2060, 98, "cudaDeviceSynchronize"),  # blocking, but outside a step
        Event("device", "late_kernel", 6000, 6100, 97),  # after the window
        _launch(4000, 97),
    ]
    return ev


def test_a_kernel_is_charged_to_the_innermost_span_at_its_launch():
    r = sites.reduce(_events())
    assert r.steps == 2
    ns = {k: v for k, v in r.ns.items()}
    assert ns[("tf.norm", "tf.norm", "elementwise")] == 20
    assert ns[("tf.transformer:down_0_0", "tf.sdp", "copies and casts")] == 60
    assert ns[("tf.transformer:down_0_0", "tf.transformer", "matmul")] == 200
    assert ns[("tf.unet", "tf.unet", "convolution")] == 80
    # the two copies launched in the transformer site itself, 2 + 1 ns a step
    assert ns[("tf.transformer:down_0_0", "tf.transformer", "copies and casts")] == 6
    assert ns[("-", "-", "copies and casts")] == 6  # the memset outside every span
    assert ns[("-", "-", "other")] == 4  # the stray kernel
    assert r.ms("tf.sdp") == pytest.approx(30e-6)
    assert r.ms("tf.transformer") == pytest.approx((60 + 200 + 6) / 2 / 1e6)
    assert r.by_kind()["tf.transformer"] == pytest.approx(
        {"matmul": 100e-6, "copies and casts": 3e-6})
    assert r.ms("tf.step") == pytest.approx((20 + 60 + 200 + 80 + 6) / 2 / 1e6)
    assert r.ms("tf.propagation") == 0.0


def test_blocking_calls_coverage_and_links():
    r = sites.reduce(_events())
    # per step the device-to-host copy and the stream synchronization; the
    # device synchronization outside a step is not counted
    assert r.syncs == 4
    assert r.runtime["cudaMemcpyAsync"][0] == 4
    assert r.device_events == 2 * 6 + 2  # the late kernel lies outside the window
    assert r.linked == r.device_events - 1
    assert r.device_ns == 366 + 6 + 4
    assert r.covered_ns == 366
    assert r.coverage == pytest.approx(100.0 * 366 / 376)
    assert r.linked_share == pytest.approx(100.0 * 13 / 14)
    table = r.table()
    assert "tf.transformer:down_0_0 > tf.sdp 0.000" in table
    assert "2.00 blocking calls a step" in table
    assert "97.340% of" in table


def test_spans_that_open_and_close_together_nest():
    """A span that opens when its parent opens is inside it; a launch at a
    span's last instant is still inside it."""
    ev = [Event("span", "tf.step", 0, 100), Event("span", "tf.unet", 0, 100),
          Event("span", "tf.norm", 0, 50), Event("span", "tf.ddim", 50, 100),
          _launch(50, 1), Event("device", "k", 200, 210, 1)]
    r = sites.reduce(ev)
    assert r.ns == {("tf.ddim", "tf.ddim", "other"): 10}
    assert r.ms("tf.norm") == 0.0 and r.ms("tf.unet") == pytest.approx(10e-6)


def test_from_kineto_reads_the_spans_and_the_window():
    """On the CPU the profiler gives the spans and the window, and no
    device event; the spans' parents follow their nesting."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.spans(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(sites.WINDOW):
            for _ in range(2):
                with profiling.span("tf.step"), profiling.span("tf.norm"):
                    torch.ones(8).sum()
    events = sites.from_kineto(prof)
    assert sorted({(e.kind, e.name) for e in events}) == [
        ("span", "tf.norm"), ("span", "tf.step"), ("window", sites.WINDOW)]
    r = sites.reduce(events)
    assert (r.steps, r.device_events, r.coverage, r.ms("tf.norm")) == (2, 0, 0.0, None)


def test_readings_without_a_card_leave_the_device_numbers_out():
    with profiling.spans() as record:
        for _ in range(2):
            with profiling.span("tf.step"):
                with profiling.span("tf.pivotal"):
                    time.sleep(0.002)
    edit = sites.readings("edit", record, None)
    assert set(edit) == {"edit.host_ms", "edit.pivotal_host_ms", "edit.syncs", "edit.norm_ms",
                         "edit.sdp_ms", "edit.match_ms"}
    assert edit["edit.host_ms"] >= edit["edit.pivotal_host_ms"] >= 2.0
    assert [k for k, v in edit.items() if v is None] == [
        "edit.syncs", "edit.norm_ms", "edit.sdp_ms", "edit.match_ms"]
    invert = sites.readings("invert", record, sites.reduce(_events()))
    assert invert["invert.syncs"] == 2.0
    assert invert["invert.norm_ms"] == pytest.approx(10e-6)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy_with_tiny_cells(tmp_path_factory.mktemp("bench"), lambda cell: {
        "state_rel_l2": 1.0, "frame_rel_l2": 1.0, "slot_gap": 0.0, "slots_wrong": 0.0})


@pytest.mark.parametrize("cell", ["tiny_pnp_edit", "tiny_invert"])
def test_bench_sites_on_a_tiny_cell(root, cell, capsys):
    rc = bench_sites.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3"],
                          root=root, device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "cpu" and out["steps"]["profiled"] == 0
    assert out["steps"]["off"] >= 1 and out["steps"]["spans_on"] >= 1
    host = [k for k, v in out["readings"].items() if v is not None]
    if cell == "tiny_pnp_edit":
        assert host == ["edit.host_ms", "edit.pivotal_host_ms"]
        assert out["readings"]["edit.host_ms"] > out["readings"]["edit.pivotal_host_ms"] > 0
    else:
        assert host == ["invert.host_ms"]
    assert "coverage_pct" not in out


def test_the_harness_windows_record_no_span(root, monkeypatch, capsys):
    """Every benchmark window runs with the program's spans off."""
    def refuse(self):
        raise AssertionError(f"span {self.name} recorded in a benchmark run")

    monkeypatch.setattr(profiling._Recording, "__enter__", refuse)
    rc = harness.main(["--workload", "tiny_pnp_edit", "--seed", str(SEED), "--seconds", "0.3",
                       "--trace", "0"], time.monotonic(), root=root, device=torch.device("cpu"))
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["attempted"] >= 1

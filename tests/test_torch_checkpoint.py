"""Checkpoint/resume and ``--then_edit`` in the port (``cli/common.py``
``SegmentCheckpointer``, ``run_segmented_edit``, ``schedule_segments``;
``cli/preprocess.py`` ``--checkpoint_inversion``, ``--then_edit``), the
twins of the JAX package's contracts in ``tests/test_e2e_cli.py``, on the
tiny stack on the CPU (fp32):

- the helper-level resume: an interrupted checkpointed edit resumes at the
  saved boundary and equals the uninterrupted run; the checkpoint is gone
  after completion;
- a stale checkpoint (another prompt, source video, start-latent geometry,
  ``prop_approx``, ``dtype``, ``group_norm_kernel``, ``fused_step``, weights
  or token ids) is ignored, by the edit and by the inversion;
- both fingerprints record the GroupNorm path ``group_norm_kernel``
  resolves to on the run's device, not the key as written;
- an unreadable file is ignored, and saves leave no temporary file;
- the ``checkpoint_every`` cadence;
- a killed and resumed inversion gives the uninterrupted trajectory bit for
  bit, also with a save-grid hole (10 steps saving 4: slot 1 never written,
  slot 2 written above it);
- a killed and resumed PnP edit through ``run_pnp.main`` gives the
  uninterrupted output bit for bit;
- ``preprocess --then_edit`` runs the inferred editor (PnP, SDEdit,
  ControlNet) in the same process on the held stack, and a config of no
  family fails before the inversion;
- the port's ``plan_seg_len``, ``segment_slices``, ``split_schedule`` and
  ``schedule_segments`` against the JAX package's over a grid of
  (n, seg_len).

Tolerance: none, every comparison is exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tokenflow_torch import runtime, utils
from tokenflow_torch.cli import common, preprocess, run_pnp
from tokenflow_torch.diffusion import ddim
from tokenflow_torch.editing import pipeline
from tokenflow_torch.io.tokenizer import HashTokenizer
from tokenflow_tpu import utils as jax_utils
from tokenflow_tpu.cli import common as jax_common
from tokenflow_tpu.diffusion import ddim as jax_ddim
from tokenflow_tpu.editing import pipeline as jax_pipeline

torch.set_num_threads(2)

F, HW = 4, 64


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_checkpoint")
    data = root / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (HW, HW, 3), dtype=np.uint8)
    for i in range(F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    return root


def _pre_args(save_dir, sd_version="tiny", steps=8, save_steps=4, *extra):
    return [
        "--data_path", "data/clip", "--H", str(HW), "--W", str(HW),
        "--sd_version", sd_version, "--init", "random", "--dtype", "f32",
        "--steps", str(steps), "--save_steps", str(save_steps), "--n_frames", str(F),
        "--batch_size", str(F), "--inversion_prompt", "a test clip", "--device", "cpu",
        "--save_dir", save_dir, "--skip_reconstruction", *extra,
    ]


def _edit_config(**kw):
    cfg = dict(
        seed=1, device="cpu", output_path="results", data_path="data/clip",
        latents_path="latents", n_inversion_steps=8, n_frames=F, sd_version="tiny",
        init="random", dtype="f32", guidance_scale=7.5, n_timesteps=4,
        prompt="a stylized test clip", negative_prompt="ugly", batch_size=2,
        pnp_attn_t=0.5, pnp_f_t=0.8, image_size=HW,
    )
    cfg.update(kw)
    return cfg


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _segments(n):
    return [(types.SimpleNamespace(timesteps=np.arange(1)), None) for _ in range(n)]


# a stack identity (cli/common.py::stack_identity) for the helper-level tests
IDENT = {"init": "random", "model_dir": None, "token_ids": "ids-a"}


def _failing(calls, at):
    def step(x, sched_seg, piv):
        calls.append(1)
        if len(calls) == at:
            raise RuntimeError("simulated kill")
        return x * 2 + 1
    return step


def test_run_segmented_edit_checkpoint_resume(tmp_path, capsys):
    config = dict(_edit_config(), output_path=str(tmp_path), checkpoint_edit=True)
    x0 = torch.arange(4.0)
    calls = []

    def step(x, sched_seg, piv):
        calls.append(1)
        return x * 2 + 1

    expected = common.run_segmented_edit(dict(config, checkpoint_edit=False), _segments(4),
                                         step, x0, IDENT)
    ckpt = tmp_path / "edit_checkpoint.npz"
    calls.clear()
    with pytest.raises(RuntimeError, match="simulated kill"):
        common.run_segmented_edit(config, _segments(4), _failing(calls, 3), x0, IDENT)
    assert ckpt.exists()  # 2 segments done, carry saved
    calls.clear()
    out = common.run_segmented_edit(config, _segments(4), step, x0, IDENT)
    assert len(calls) == 2  # resumed: only the 2 remaining segments ran
    assert "resuming at segment 3/4" in capsys.readouterr().out
    assert torch.equal(out, expected)
    assert not ckpt.exists()  # removed on completion


@pytest.mark.parametrize(
    "change",
    [dict(prompt="different"), dict(data_path="data/video_b"), dict(prop_approx=True),
     dict(dtype="bf16"), dict(group_norm_kernel=True), dict(fused_step=True), "x_init",
     dict(init="pretrained", model_dir="/ckpt/sd21"), dict(model_dir="/ckpt/other"),
     dict(token_ids="ids-b")],
    ids=["prompt", "data_path", "prop_approx", "dtype", "group_norm_kernel", "fused_step",
         "x_init", "init", "model_dir", "token_ids"],
)
def test_stale_checkpoint_is_ignored(tmp_path, change):
    """A checkpoint never seeds a run whose config, numerics, input or stack
    differ; the port's own ``dtype``, ``group_norm_kernel`` and
    ``fused_step`` are part of the run's identity (K4 and ``F.group_norm``,
    one UNet call a step or two, differ in their last bits),
    and so are the resolved weights (``init`` and ``model_dir``: with
    ``init: auto`` one YAML runs on either) and the prompts' token ids."""
    config = dict(_edit_config(), output_path=str(tmp_path), checkpoint_edit=True)
    x0 = torch.arange(4.0)
    calls = []
    with pytest.raises(RuntimeError):
        common.run_segmented_edit(config, _segments(4), _failing(calls, 3), x0, IDENT)
    assert (tmp_path / "edit_checkpoint.npz").exists()
    other, x1, ident = config, x0, IDENT
    if change == "x_init":
        x1 = torch.arange(8.0)
    elif set(change) <= set(IDENT):
        ident = dict(IDENT, **change)
    else:
        other = dict(config, **change)
    calls.clear()
    common.run_segmented_edit(other, _segments(4), _failing(calls, 99), x1, ident)
    assert len(calls) == 4  # fingerprint mismatch: started from scratch


# (device, two settings of group_norm_kernel that resolve to one path there,
# one that resolves to another): on the CPU unset and false both run
# F.group_norm and true the plain version; on CUDA unset and true both run
# K4 and false F.group_norm
RESOLVED_GN = [("cpu", (None, False), True), ("cuda", (None, True), False)]


@pytest.mark.parametrize("device,same,other", RESOLVED_GN, ids=["cpu", "cuda"])
def test_edit_fingerprint_records_the_resolved_group_norm_path(device, same, other):
    def fingerprint(value):
        cfg = _edit_config(device=device)
        if value is not None:
            cfg["group_norm_kernel"] = value
        return common._edit_fingerprint(cfg, _segments(2), torch.arange(4.0), IDENT)

    assert fingerprint(same[0]) == fingerprint(same[1])
    assert fingerprint(other) != fingerprint(same[0])


@pytest.mark.parametrize("device,same,other", RESOLVED_GN, ids=["cpu", "cuda"])
def test_inversion_fingerprint_records_the_resolved_group_norm_path(device, same, other):
    def fingerprint(value):
        args = _pre_args("latents")
        args[args.index("--device") + 1] = device
        if value is not None:
            args += ["--group_norm_kernel", str(value).lower()]
        opt = preprocess.build_parser().parse_args(args)
        return preprocess._inversion_fingerprint(opt, utils.segment_slices(8, 3), IDENT)

    assert fingerprint(same[0]) == fingerprint(same[1])
    assert fingerprint(other) != fingerprint(same[0])


@pytest.mark.parametrize("flag,want", [((), None), (("--group_norm_kernel",), True),
                                       (("--group_norm_kernel", "true"), True),
                                       (("--group_norm_kernel", "false"), False)])
def test_preprocess_group_norm_flag(flag, want):
    """The flag: absent is unset (the device decides), bare or ``true`` is
    true, ``false`` is false."""
    opt = preprocess.build_parser().parse_args(_pre_args("latents", "tiny", 8, 4, *flag))
    assert opt.group_norm_kernel is want


@pytest.mark.parametrize(
    "change", [dict(init="pretrained", model_dir="/ckpt/sd21"), dict(model_dir="/ckpt/other"),
               dict(token_ids="ids-b")],
    ids=["init", "model_dir", "token_ids"],
)
def test_inversion_fingerprint_covers_the_stack(change):
    opt = preprocess.build_parser().parse_args(_pre_args("latents"))
    slices = utils.segment_slices(8, 3)
    assert (preprocess._inversion_fingerprint(opt, slices, dict(IDENT, **change))
            != preprocess._inversion_fingerprint(opt, slices, IDENT))


def test_stack_identity():
    stack = runtime.load_stack("tiny", device="cpu", init="random", dtype=torch.float32)
    ident = common.stack_identity(stack, "a test clip", "ugly")
    assert ident["init"] == "random" and ident["model_dir"] is None
    assert ident == common.stack_identity(stack, "a test clip", "ugly")
    assert ident != common.stack_identity(stack, "another clip", "ugly")
    pretrained = dataclasses.replace(stack, model_dir="/ckpt/sd21")
    assert common.stack_identity(pretrained, "a test clip", "ugly")["init"] == "pretrained"


def test_inversion_checkpoint_of_other_token_ids_is_stale(workdir, monkeypatch, capsys):
    """A random-init stack's HashTokenizer hashes words with Python's
    salted ``hash()``: a process with another hash seed gives the prompt
    other ids, so its checkpoint is refused and the inversion starts over
    (simulated here by shifting every word id)."""
    monkeypatch.chdir(workdir)
    args = _pre_args("latents_ids", "tiny", 8, 4, "--checkpoint_inversion",
                     "--steps_per_dispatch", "3")
    orig_save = common.SegmentCheckpointer.save

    def bombed_save(self, i, n, carry):
        orig_save(self, i, n, carry)
        raise RuntimeError("simulated kill")

    monkeypatch.setattr(common.SegmentCheckpointer, "save", bombed_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        preprocess.main(args)
    monkeypatch.setattr(common.SegmentCheckpointer, "save", orig_save)
    orig_call = HashTokenizer.__call__

    def other_seed(self, text, max_length=None):
        ids = orig_call(self, text, max_length)
        return [i if i < 2 else 2 + (i - 1) % (self.vocab_size - 2) for i in ids]

    monkeypatch.setattr(HashTokenizer, "__call__", other_seed)
    capsys.readouterr()
    resumed = preprocess.main(args)
    out = capsys.readouterr().out
    assert "ignoring stale" in out and "resuming at segment" not in out
    assert not (workdir / resumed["save_path"] / "inversion_checkpoint.npz").exists()


def test_segment_checkpointer_unreadable_file(tmp_path, capsys):
    path = tmp_path / "ck.npz"
    path.write_bytes(b"PK\x03\x04 this is not a real npz")
    ck = common.SegmentCheckpointer(str(path), "fp", True)
    carry = (torch.arange(3.0), torch.arange(6, dtype=torch.bfloat16))
    done, restored = ck.resume(carry, 4)
    assert done == 0 and restored is carry
    assert "unreadable" in capsys.readouterr().out
    # a save goes through a temporary file and a rename: the final path is
    # a loadable npz, and bf16 round-trips through its uint16 view
    ck.save(0, 4, carry)
    assert not list(tmp_path.glob("*.tmp.npz"))
    with np.load(path) as f:
        assert str(f["dtype_1"]) == "bfloat16" and f["carry_1"].dtype == np.uint16
    done, (a, b) = ck.resume(carry, 4)
    assert done == 1 and torch.equal(a, carry[0])
    assert b.dtype == torch.bfloat16 and torch.equal(b, carry[1])


def test_segment_checkpointer_save_cadence(tmp_path):
    path = tmp_path / "ck.npz"
    ck = common.SegmentCheckpointer(str(path), "fp", True, every=2)
    carry = (torch.arange(2.0),)
    ck.save(0, 5, carry)  # boundary 1: skipped
    assert not path.exists()
    ck.save(1, 5, carry)  # boundary 2: saved
    assert ck.resume(carry, 5)[0] == 2
    ck.save(2, 5, carry)  # boundary 3: skipped, the checkpoint stays at 2
    assert ck.resume(carry, 5)[0] == 2
    ck.save(4, 5, carry)  # the last segment is never saved
    assert ck.resume(carry, 5)[0] == 2
    ck.done()
    assert not path.exists()


@pytest.mark.parametrize("steps,kill_after", [(8, 0), (10, 2)], ids=["no_hole", "save_grid_hole"])
def test_inversion_checkpoint_resume(workdir, monkeypatch, capsys, steps, kill_after):
    """Kill preprocess after segment ``kill_after`` (segments of <= 3
    steps), rerun, and get the uninterrupted trajectory bit for bit. At 10
    steps saving 4, slot 1 is not on the inversion grid and stays zero,
    and the kill lands right after the segment that wrote slot 2 above it:
    the resume must restore that row."""
    monkeypatch.chdir(workdir)
    base = preprocess.main(_pre_args(f"latents_base_{steps}", "tiny", steps))
    args = _pre_args(f"latents_ck_{steps}", "tiny", steps, 4,
                     "--checkpoint_inversion", "--steps_per_dispatch", "3")
    orig_save = common.SegmentCheckpointer.save

    def bombed_save(self, i, n, carry):
        orig_save(self, i, n, carry)
        if i == kill_after:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(common.SegmentCheckpointer, "save", bombed_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        preprocess.main(args)
    assert len(list((workdir / f"latents_ck_{steps}").rglob("inversion_checkpoint.npz"))) == 1
    monkeypatch.setattr(common.SegmentCheckpointer, "save", orig_save)
    capsys.readouterr()
    resumed = preprocess.main(args)
    assert f"resuming at segment {kill_after + 2}/" in capsys.readouterr().out
    sp = workdir / resumed["save_path"]
    assert not (sp / "inversion_checkpoint.npz").exists()
    a = np.load(workdir / base["save_path"] / "latents" / "trajectory.npz")
    b = np.load(sp / "latents" / "trajectory.npz")
    np.testing.assert_array_equal(b["traj"], a["traj"])
    np.testing.assert_array_equal(b["final"], a["final"])
    if steps == 10:
        assert np.abs(b["traj"][2]).sum() > 0  # written above the hole
        assert np.abs(b["traj"][1]).sum() == 0  # the hole stays zero


def test_pnp_edit_checkpoint_resume(workdir, monkeypatch, capsys):
    """Kill the edit in its third segment (one step each), rerun the same
    YAML through ``run_pnp.main``, and get the uninterrupted output bit for
    bit; the checkpoint is gone afterwards."""
    monkeypatch.chdir(workdir)
    preprocess.main(_pre_args("latents"))
    base = run_pnp.main(["--config_path", _write(
        workdir / "pnp_base.yaml", _edit_config(output_path="results_base"))])
    path = _write(workdir / "pnp_ck.yaml", _edit_config(
        output_path="results_ck", checkpoint_edit=True, steps_per_dispatch=1))
    orig = common.run_segmented_edit

    def interrupted(cfg, segments, step_fn, x_init, identity):
        calls = []

        def wrapped(x, s, p):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("simulated kill")
            return step_fn(x, s, p)

        return orig(cfg, segments, wrapped, x_init, identity)

    monkeypatch.setattr(common, "run_segmented_edit", interrupted)
    with pytest.raises(RuntimeError, match="simulated kill"):
        run_pnp.main(["--config_path", path])
    out_dir = run_pnp.resolve_output_path(_edit_config(output_path="results_ck"))["output_path"]
    ckpt = workdir / out_dir / "edit_checkpoint.npz"
    assert ckpt.exists()
    monkeypatch.setattr(common, "run_segmented_edit", orig)
    capsys.readouterr()
    decoded = run_pnp.main(["--config_path", path])
    assert "resuming at segment 3/4" in capsys.readouterr().out
    assert not ckpt.exists()
    np.testing.assert_array_equal(decoded, base)


@pytest.mark.parametrize("family", ["pnp", "sdedit", "controlnet"])
def test_then_edit_runs_the_editor_in_process(workdir, monkeypatch, capsys, family):
    """``preprocess --then_edit`` infers the editor at parse time and runs it
    after the inversion in this process, on the stack preprocess built (one
    build of ``runtime._build_stack``)."""
    monkeypatch.chdir(workdir)
    sd_version = "tiny-controlnet" if family == "controlnet" else "tiny"
    cfg = _edit_config(output_path=f"results_then_{family}", latents_path=f"latents_{family}",
                       sd_version=sd_version)
    if family == "sdedit":
        cfg["start"] = 0.9
    if family != "pnp":
        del cfg["pnp_attn_t"], cfg["pnp_f_t"]
    path = _write(workdir / f"then_{family}.yaml", cfg)
    runtime._build_stack.cache_clear()
    preprocess.main(_pre_args(f"latents_{family}", sd_version, 8, 4, "--then_edit", path))
    editor = {"pnp": "run_pnp", "sdedit": "run_sdedit", "controlnet": "run_controlnet"}[family]
    assert f"--then_edit: running tokenflow_torch.cli.{editor}" in capsys.readouterr().out
    assert runtime._build_stack.cache_info().misses == 1
    resolve = {"pnp": run_pnp.resolve_output_path}.get(family)
    if resolve is None:
        from tokenflow_torch.cli import run_controlnet, run_sdedit

        resolve = (run_sdedit if family == "sdedit" else run_controlnet).resolve_output_path
    assert (workdir / resolve(dict(cfg))["output_path"] / "img_ode" / "00000.png").exists()


def test_then_edit_wrong_config_fails_before_inversion(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    cfg = _edit_config()
    del cfg["pnp_attn_t"], cfg["pnp_f_t"]  # neither PnP nor SDEdit, not a ControlNet
    path = _write(workdir / "then_none.yaml", cfg)

    def no_run(opt):
        raise AssertionError("the inversion ran")

    monkeypatch.setattr(preprocess, "run", no_run)
    with pytest.raises(ValueError, match="cannot infer the editor family"):
        preprocess.main(_pre_args("latents_none", "tiny", 8, 4, "--then_edit", path))


@pytest.mark.parametrize("n", [1, 4, 7, 10, 12, 20, 50, 97])
def test_segmentation_plan_matches_jax(n):
    for seg_len in range(-1, n + 3):
        planned = utils.plan_seg_len(n, seg_len)
        assert planned == jax_utils.plan_seg_len(n, seg_len), (n, seg_len)
        assert utils.segment_slices(n, seg_len) == jax_utils.segment_slices(n, seg_len)
        assert utils.segment_slices(n, planned) == jax_utils.segment_slices(n, planned)


@pytest.mark.parametrize("n_timesteps,seg_len", [(10, 2), (10, 3), (50, 20), (25, 7)])
def test_split_schedule_and_segments_match_jax(n_timesteps, seg_len):
    save_ts = ddim.save_grid(50, 50)[0]
    schedule = pipeline.make_edit_schedule(ddim.make_schedule(n_timesteps), save_ts,
                                           pnp_attn_t=0.5, pnp_f_t=0.8)
    jschedule = jax_pipeline.make_edit_schedule(jax_ddim.make_schedule(n_timesteps), save_ts,
                                                pnp_attn_t=0.5, pnp_f_t=0.8)
    got, want = pipeline.split_schedule(schedule, seg_len), jax_pipeline.split_schedule(
        jschedule, seg_len)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("timesteps", "alpha_t", "alpha_prev", "src_slot", "qk_gate", "conv_gate"):
            np.testing.assert_array_equal(np.asarray(getattr(g, field)),
                                          np.asarray(getattr(w, field)), err_msg=field)
    pivots = np.arange(n_timesteps * 2, dtype=np.int32).reshape(n_timesteps, 2)
    config = {"steps_per_dispatch": seg_len, "checkpoint_edit": True}
    segs = common.schedule_segments(config, schedule, pivots)
    jsegs = jax_common.schedule_segments(config, jschedule, pivots)
    assert [len(s.timesteps) for s, _ in segs] == [len(s.timesteps) for s, _ in jsegs]
    for (_, p), (_, q) in zip(segs, jsegs):
        np.testing.assert_array_equal(p, q)
    # without checkpoint_edit the port runs one segment, whatever
    # steps_per_dispatch says
    assert len(common.schedule_segments({"steps_per_dispatch": seg_len}, schedule, pivots)) == 1

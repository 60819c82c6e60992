"""The port's CLIs end to end on the tiny stack on the CPU: preprocess
(inversion + reconstruction), then the PnP editor (exact, with
``prop_approx: true`` and with ``fused_step: true``, one UNet call a
step), the SDEdit editor
(with every GroupNorm on the GroupNorm kernel's switch) and the vanilla
SDEdit baseline, then preprocess and the ControlNet editor on the
tiny-controlnet stack, then preprocess and the PnP editor (exact and
``prop_approx``) on the tiny-depth stack with precomputed depth maps, in a
fresh subprocess that must never import JAX, any module of the JAX package
or ``transformers``. Checks the artifact tree that tests/test_e2e_cli.py
asserts for the JAX CLIs, that the trajectory reads back through
tokenflow_tpu.io.latents, the device rules, the config keys the port
refuses (features it lacks) or ignores (the JAX relay's), that fp32 on a
CUDA device gets past the config's checks, and that an fp32 run turns
TF32 off.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tokenflow_torch import utils
from tokenflow_torch.cli import common, preprocess
from tokenflow_tpu.io import latents as latents_io

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F, HW, STEPS, SAVE_STEPS, N_TIMESTEPS = 4, 64, 8, 4, 4

SCRIPT = textwrap.dedent(
    f"""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    # PyTorch's default for cuDNN, set for matmuls too: the fp32 CLIs must
    # turn both off
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    import yaml
    from tokenflow_torch.cli import preprocess, run_controlnet, run_pnp, run_sdedit

    pre = preprocess.main([
        "--data_path", "data/clip", "--H", "{HW}", "--W", "{HW}",
        "--sd_version", "tiny", "--init", "random", "--dtype", "f32",
        "--steps", "{STEPS}", "--save_steps", "{SAVE_STEPS}",
        "--n_frames", "{F}", "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--device", "cpu",
    ])
    config = dict(
        seed=1, device="cpu", output_path="results", data_path="data/clip",
        latents_path="latents", n_inversion_steps={STEPS}, n_frames={F},
        sd_version="tiny", init="random", dtype="f32", guidance_scale=7.5,
        n_timesteps={N_TIMESTEPS}, prompt="a stylized test clip",
        negative_prompt="ugly", batch_size=2, pnp_attn_t=0.5, pnp_f_t=0.8,
        image_size={HW}, propagate_chunk=2,
    )
    with open("config_pnp.yaml", "w") as f:
        yaml.safe_dump(config, f)
    decoded = run_pnp.main(["--config_path", "config_pnp.yaml"])
    out = run_pnp.resolve_output_path(dict(config))["output_path"]
    variants = {{}}
    for name, extra in (("approx", dict(prop_approx=True)),
                        # unchunked: a chunked propagation runs two passes
                        ("fused", dict(fused_step=True, propagate_chunk=None))):
        cfg = dict(config, output_path="results_" + name, **extra)
        with open(f"config_pnp_{{name}}.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        frames = run_pnp.main(["--config_path", f"config_pnp_{{name}}.yaml"])
        variants[name] = {{
            "path": run_pnp.resolve_output_path(dict(cfg))["output_path"],
            "shape": list(frames.shape), "finite": bool(np.isfinite(frames).all()),
            "max_diff_exact": float(np.abs(frames.astype(np.float64) - decoded).max()),
            "max_abs_exact": float(np.abs(decoded).max()),
        }}
    sdedit = dict(config, start=0.9, group_norm_kernel=True)
    for k in ("n_inversion_steps", "pnp_attn_t", "pnp_f_t"):
        del sdedit[k]
    with open("config_sdedit.yaml", "w") as f:
        yaml.safe_dump(sdedit, f)
    sd = run_sdedit.main(["--config_path", "config_sdedit.yaml"])
    with open("config_vanilla.yaml", "w") as f:
        yaml.safe_dump(dict(sdedit, group_norm_kernel=False), f)
    van = run_sdedit.main(["--config_path", "config_vanilla.yaml", "--vanilla"])
    cn_pre = preprocess.main([
        "--data_path", "data/clip", "--H", "{HW}", "--W", "{HW}",
        "--sd_version", "tiny-controlnet", "--init", "random", "--dtype", "f32",
        "--steps", "{STEPS}", "--save_steps", "{SAVE_STEPS}",
        "--n_frames", "{F}", "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--device", "cpu",
    ])
    cn_config = dict(config, sd_version="tiny-controlnet", steps_per_dispatch=2,
                     frames_per_dispatch=2, compile_ahead=True, data_parallel="auto")
    for k in ("pnp_attn_t", "pnp_f_t"):
        del cn_config[k]
    with open("config_controlnet.yaml", "w") as f:
        yaml.safe_dump(cn_config, f)
    cn = run_controlnet.main(["--config_path", "config_controlnet.yaml"])
    depth_pre = preprocess.main([
        "--data_path", "data/clip", "--H", "{HW}", "--W", "{HW}",
        "--sd_version", "tiny-depth", "--init", "random", "--dtype", "f32",
        "--steps", "{STEPS}", "--save_steps", "{SAVE_STEPS}",
        "--n_frames", "{F}", "--batch_size", "2",
        "--inversion_prompt", "a test clip", "--device", "cpu",
    ])
    depth_runs = {{}}
    for name, extra in (("depth", {{}}), ("depth_approx", dict(prop_approx=True))):
        cfg = dict(config, sd_version="tiny-depth", output_path="results_" + name, **extra)
        with open(f"config_{{name}}.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        frames = run_pnp.main(["--config_path", f"config_{{name}}.yaml"])
        depth_runs[name] = {{
            "path": run_pnp.resolve_output_path(dict(cfg))["output_path"],
            "shape": list(frames.shape), "finite": bool(np.isfinite(frames).all()),
        }}
    print("RESULT " + json.dumps({{
        "save_path": pre["save_path"],
        "output_path": out,
        "pnp_variants": variants,
        "sdedit_path": run_sdedit.resolve_output_path(dict(sdedit))["output_path"],
        "shape": list(decoded.shape),
        "finite": bool(np.isfinite(decoded).all()),
        "sdedit_shapes": [list(sd.shape), list(van.shape)],
        "sdedit_finite": bool(np.isfinite(sd).all() and np.isfinite(van).all()),
        "controlnet_save_path": cn_pre["save_path"],
        "controlnet_path": run_controlnet.resolve_output_path(dict(cn_config))["output_path"],
        "controlnet_shape": list(cn.shape),
        "controlnet_finite": bool(np.isfinite(cn).all()),
        "depth_save_path": depth_pre["save_path"],
        "depth_seconds": depth_pre.get("depth_seconds"),
        "depth_runs": depth_runs,
        "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32],
        "jax_loaded": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "flax", "jaxlib", "tokenflow_tpu", "transformers")
        ),
    }}))
    """
)


@pytest.fixture(scope="module")
def run_cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "data" / "clip"
    data.mkdir(parents=True)
    (data / "depth").mkdir()
    base = np.random.default_rng(0).integers(40, 210, (HW, HW, 3), dtype=np.uint8)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:37, 0:41]
    for i in range(F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
        # raw depth maps of another size than the frames (tests/test_e2e_cli.py)
        np.save(data / "depth" / f"{i:05d}.npy",
                (yy * 10.0 + xx + rng.random((37, 41)) * 5 + i).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=root, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return root, json.loads(line[len("RESULT "):])


def test_cli_never_imports_jax(run_cli):
    _, result = run_cli
    assert result["jax_loaded"] == []


def test_preprocess_artifacts(run_cli):
    root, result = run_cli
    sp = root / result["save_path"]
    assert (sp / "latents" / "trajectory.npz").exists()
    assert (sp / "inversion_prompt.txt").read_text() == "a test clip"
    assert (sp / "inverted.mp4").exists()
    assert (sp / "frames" / "00000.png").exists()
    assert (root / "latents" / "inversion_prompts.yaml").exists()
    traj = latents_io.load_trajectory(str(sp))
    lat = HW // 2  # the tiny VAE downsamples once
    assert traj.traj.shape == (SAVE_STEPS, F, lat, lat, 4)
    assert traj.final.shape == (F, lat, lat, 4)
    assert np.isfinite(traj.traj).all() and traj.final_t == 876


def test_pnp_artifacts(run_cli):
    root, result = run_cli
    assert result["shape"] == [F, HW, HW, 3] and result["finite"]
    out = root / result["output_path"]
    for name in (
        "img_ode/00000.png", "tokenflow_PnP_fps_10.mp4", "vae_recon_10.mp4",
        "input_fps10.mp4", "config.yaml", "metrics.json", "pivots.json",
    ):
        assert (out / name).exists(), name
    metrics = json.loads((out / "metrics.json").read_text())
    phases = metrics["phases_seconds"]
    for name in ("vae_recon", "edit_loop", "edit_pivotal", "edit_propagate", "decode"):
        assert name in phases, name
    assert metrics["device"] == "cpu" and metrics["n_steps"] == N_TIMESTEPS
    pivots = np.asarray(json.loads((out / "pivots.json").read_text())["pivot_indices"])
    assert pivots.shape == (N_TIMESTEPS, F // 2)


@pytest.mark.parametrize("variant", ["approx", "fused"])
def test_pnp_variant_artifacts(run_cli, variant):
    """``prop_approx: true`` runs the two passes, source-free propagation,
    to another output than the exact run's; ``fused_step: true`` runs one
    UNet call a step (the ``edit_fused`` phase), to the exact run's output
    within the fused-against-two-pass tolerance of
    tests/test_pipeline.py::test_fused_step_matches_two_pass (2e-4
    relative)."""
    root, result = run_cli
    run = result["pnp_variants"][variant]
    assert run["shape"] == [F, HW, HW, 3] and run["finite"]
    out = root / run["path"]
    assert out.parts[-6].endswith(f"results_{variant}_pnp_SD_tiny")
    for name in ("img_ode/00000.png", "tokenflow_PnP_fps_10.mp4", "config.yaml",
                 "metrics.json", "pivots.json"):
        assert (out / name).exists(), name
    phases = set(json.loads((out / "metrics.json").read_text())["phases_seconds"])
    if variant == "fused":
        assert "edit_fused" in phases
        assert not {"edit_pivotal", "edit_propagate"} & phases
        assert run["max_diff_exact"] <= 2e-4 * run["max_abs_exact"]
    else:
        assert {"edit_pivotal", "edit_propagate"} <= phases
        assert run["max_diff_exact"] > 0


@pytest.mark.parametrize("vanilla", [False, True])
def test_sdedit_artifacts(run_cli, vanilla):
    root, result = run_cli
    assert result["sdedit_finite"]
    assert result["sdedit_shapes"][int(vanilla)] == [F, HW, HW, 3]
    out = root / result["sdedit_path"]
    assert out.parts[-2:] == ("batch_size_2", f"{N_TIMESTEPS}start_0.9")
    assert out.parts[-5].endswith("results_sdedit")
    if vanilla:
        names = ("img_ode_vanilla_sde/00000.png", "vanilla_sde.mp4",
                 "vanilla_sde_fps20.mp4", "vanilla_sde_fps30.mp4",
                 "metrics_vanilla.json")
    else:
        names = ("img_ode/00000.png", "tokenflow_SDEdit_fps_10.mp4",
                 "tokenflow_SDEdit_fps_20.mp4", "tokenflow_SDEdit_fps_30.mp4",
                 "input_fps10.mp4", "config.yaml", "metrics.json", "pivots.json")
    for name in names:
        assert (out / name).exists(), name
    metrics = json.loads((out / ("metrics_vanilla.json" if vanilla else "metrics.json")).read_text())
    phases = metrics["phases_seconds"]
    assert {"edit_loop", "decode", "decode_and_save"} <= set(phases)
    if not vanilla:
        assert {"edit_pivotal", "edit_propagate"} <= set(phases)
    # start 0.9 of 4 timesteps: timesteps[int(1 - 3.6):], two steps
    assert metrics["n_steps"] == 2 and metrics["vanilla"] is vanilla


def test_controlnet_artifacts(run_cli):
    root, result = run_cli
    sp = root / result["controlnet_save_path"]
    assert sp.parts[-4:-2] == ("sd_tiny-controlnet", "clip")
    assert (sp / "latents" / "trajectory.npz").exists() and (sp / "inverted.mp4").exists()
    assert result["controlnet_shape"] == [F, HW, HW, 3] and result["controlnet_finite"]
    out = root / result["controlnet_path"]
    assert out.parts[-5].endswith("results_controlnet")
    assert out.parts[-2:] == ("batch_size_2", str(N_TIMESTEPS))
    for name in (
        "img_ode/00000.png", "tokenflow_ControlNet_fps_10.mp4",
        "tokenflow_ControlNet_fps_20.mp4", "tokenflow_ControlNet_fps_30.mp4",
        "vae_recon_10.mp4", "input_fps10.mp4", "config.yaml", "metrics.json", "pivots.json",
    ):
        assert (out / name).exists(), name
    metrics = json.loads((out / "metrics.json").read_text())
    for name in ("vae_recon", "edit_loop", "edit_pivotal", "edit_propagate", "decode"):
        assert name in metrics["phases_seconds"], name
    assert metrics["device"] == "cpu" and metrics["n_steps"] == N_TIMESTEPS


@pytest.mark.parametrize("run", ["depth", "depth_approx"])
def test_depth_artifacts(run_cli, run):
    """preprocess --sd_version tiny-depth reads the precomputed maps (no
    DPT runs), and the PnP editor edits with them, exact and under
    prop_approx."""
    root, result = run_cli
    sp = root / result["depth_save_path"]
    assert sp.parts[-4:-2] == ("sd_tiny-depth", "clip")
    assert (sp / "latents" / "trajectory.npz").exists() and (sp / "inverted.mp4").exists()
    assert result["depth_seconds"] is not None
    traj = latents_io.load_trajectory(str(sp))
    assert traj.traj.shape[-1] == 4 and np.isfinite(traj.traj).all()
    edit = result["depth_runs"][run]
    assert edit["shape"] == [F, HW, HW, 3] and edit["finite"]
    out = root / edit["path"]
    assert out.parts[-6].endswith(f"results_{run}_pnp_SD_tiny-depth")
    for name in ("img_ode/00000.png", "tokenflow_PnP_fps_10.mp4", "vae_recon_10.mp4",
                 "input_fps10.mp4", "config.yaml", "metrics.json", "pivots.json"):
        assert (out / name).exists(), name
    phases = json.loads((out / "metrics.json").read_text())["phases_seconds"]
    assert {"edit_pivotal", "edit_propagate", "decode"} <= set(phases)


@pytest.mark.parametrize("sd_version", ["depth", "tiny-depth"])
def test_sdedit_config_refuses_depth(sd_version):
    """SDEdit refuses the depth models at config time, with the JAX
    editor's message; PnP takes them."""
    base = dict.fromkeys(common.REQUIRED_KEYS["base"], 0)
    base.update(batch_size=2, device="cpu", start=0.9, sd_version=sd_version)
    with pytest.raises(ValueError, match="SDEdit does not support depth-conditioned models"):
        common.validate_config(base, "sdedit")
    pnp = dict(base, n_inversion_steps=8, pnp_attn_t=0.5, pnp_f_t=0.8)
    common.validate_config(pnp, "pnp")


def test_preprocess_names_depth_versions():
    args = preprocess.build_parser().parse_args(
        ["--sd_version", "depth", "--depth_model_dir", "ckpt/dpt-large"])
    assert args.sd_version == "depth" and args.depth_model_dir == "ckpt/dpt-large"
    assert preprocess.build_parser().parse_args(
        ["--sd_version", "tiny-depth"]).depth_model_dir is None


def _controlnet_base(**kw):
    base = dict.fromkeys(common.REQUIRED_KEYS["base"] + common.REQUIRED_KEYS["controlnet"], 0)
    base.update({"batch_size": 2, "device": "cpu", **kw})
    return base


@pytest.mark.parametrize(
    "key,value,item",
    [("checkpoint_edit", True, "A15"), ("checkpoint_every", 5, "A15"),
     ("data_parallel", 2, "A16"), ("data_parallel", "4", "A16"),
     ("shard_pivotal", False, "A16")],
)
def test_config_refuses_unported_features(key, value, item, monkeypatch):
    """The keys of JAX features the port lacked were refused until their
    ROADMAP item landed, and both items have: A15's keys (checkpoint/resume)
    are accepted, and A16's (frames sharding) follow the launcher:
    ``data_parallel: 2`` in a process started alone raises and names the
    launcher, ``data_parallel: "4"`` under a 2-process launcher raises, and
    ``shard_pivotal: false`` is accepted (its edit equals ``true``'s:
    ``test_cli_under_launcher_matches_one_process`` and
    tests/test_torch_sharding.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    config = _controlnet_base(**{key: value})
    if key != "data_parallel":
        assert common.validate_config(config, "controlnet")[key] == value
        return
    if value == "4":
        monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="torchrun" if value == 2 else "WORLD_SIZE=2"):
        common.validate_config(config, "controlnet")


@pytest.mark.parametrize(
    "extra",
    [dict(prop_approx=False, fused_step=False, checkpoint_edit=False, checkpoint_every=1),
     dict(data_parallel="auto", shard_pivotal=True), dict(data_parallel="off"),
     dict(data_parallel=1), dict(steps_per_dispatch=5, frames_per_dispatch=8,
                                 compile_ahead=True),
     dict(prop_approx=True), dict(fused_step=True)],
    ids=["defaults", "auto", "off", "one_device", "relay_keys", "prop_approx", "fused_step"],
)
def test_config_accepts_defaults_and_relay_keys(extra):
    common.validate_config(_controlnet_base(**extra), "controlnet")


def test_f32_on_cuda_gets_past_the_dtype_check():
    """K1 and the match core have fp32 kernels, so neither the config nor
    preprocess's arguments refuse fp32 on a CUDA device: both get as far as
    the device check, which raises here only because there is no GPU."""
    common.validate_config(_controlnet_base(dtype="f32"), "controlnet")
    if torch.cuda.is_available():
        common.validate_config(_controlnet_base(dtype="f32", device="cuda"), "controlnet")
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        common.validate_config(_controlnet_base(dtype="f32", device="cuda"), "controlnet")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        preprocess.main(["--data_path", "data/none", "--device", "cuda", "--dtype", "f32",
                         "--sd_version", "tiny"])


def test_f32_cli_turns_tf32_off(run_cli):
    """The fp32 CLIs (preprocess and the editors, dtype f32) leave TF32 off
    for matmuls and cuDNN convolutions, whatever they were before: the
    port's fp32 runs take full fp32 products, as the JAX reference does."""
    _, result = run_cli
    assert result["allow_tf32"] == [False, False]


@pytest.mark.parametrize("key", ["prop_approx", "fused_step", "group_norm_kernel",
                                 "shard_pivotal"])
def test_config_switches_must_be_booleans(key):
    with pytest.raises(ValueError, match=f"{key} must be true or false"):
        common.validate_config(_controlnet_base(**{key: "yes"}), "controlnet")


def test_sdedit_config_keys():
    base = dict.fromkeys(common.REQUIRED_KEYS["base"], 0)
    base.update(batch_size=2, device="cpu")
    with pytest.raises(KeyError, match="start"):
        common.validate_config(base, "sdedit")
    common.validate_config(dict(base, start=0.9, group_norm_kernel=True), "sdedit")
    with pytest.raises(ValueError, match="group_norm_kernel"):
        common.validate_config(dict(base, start=0.9, group_norm_kernel="yes"), "sdedit")


def test_device_rules():
    assert utils.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda"):
        utils.resolve_device("tpu")
    base = dict.fromkeys(common.REQUIRED_KEYS["base"] + common.REQUIRED_KEYS["pnp"], 0)
    base["batch_size"] = 2
    with pytest.raises(ValueError, match="cuda"):
        common.validate_config(dict(base, device="tpu"), "pnp")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        utils.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        common.validate_config(dict(base, device="cuda"), "pnp")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        preprocess.main(["--data_path", "data/none", "--device", "cuda", "--sd_version", "tiny"])


LAUNCHED = textwrap.dedent(
    """
    # runs a module as __main__; on a rank other than 0 it records every
    # write under the working directory (audit events) and prints them at exit
    import atexit, json, os, runpy, sys

    root, writes = os.getcwd(), []

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (any(c in mode for c in "wax+") if isinstance(mode, str) else
                       isinstance(flags, int) and bool(flags & (os.O_WRONLY | os.O_RDWR)))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir"):
            path, writing = args[0], True
        else:
            return
        if writing and isinstance(path, (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(path))
            if path.startswith(root):
                writes.append(f"{event} {path}")

    if os.environ["RANK"] != "0":
        sys.addaudithook(audit)
        atexit.register(lambda: print("RANK_WRITES " + json.dumps(writes), flush=True))
    sys.argv = sys.argv[1:]
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
    """
)


def _tree(root: Path, sub: str) -> dict:
    return {p.relative_to(root / sub).as_posix(): p for p in sorted((root / sub).rglob("*"))
            if p.is_file()}


def test_cli_under_launcher_matches_one_process(tmp_path):
    """preprocess (``--data_parallel 2``) and run_pnp (``data_parallel: 2``,
    with ``shard_pivotal`` true and false) under torchrun with 2 CPU ranks,
    against the same CLIs in one process: the same files in the latents and
    output trees, the trajectory within 1e-4 and the PNG frames within one
    8-bit level (per-rank batch sizes change the CPU's summation order), the
    same pivots and configs but for the sharding keys, and rank 1 writes
    nothing (an audit hook records every write it makes under the working
    directory): of the two ranks, rank 0 alone writes the ``trace_dir``
    trace. ``PYTHONHASHSEED`` is pinned: a random-weight stack's
    tokenizer hashes words per process."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED="0", OMP_NUM_THREADS="1",
               PYTHONDONTWRITEBYTECODE="1")
    env.pop("WORLD_SIZE", None)
    pre = ["tokenflow_torch.cli.preprocess", "--data_path", "data/clip", "--H", str(HW),
           "--W", str(HW), "--sd_version", "tiny", "--init", "random", "--dtype", "f32",
           "--steps", str(STEPS), "--save_steps", str(SAVE_STEPS), "--n_frames", str(F),
           "--batch_size", "2", "--inversion_prompt", "a test clip", "--device", "cpu"]
    config = dict(seed=1, device="cpu", output_path="results", data_path="data/clip",
                  latents_path="latents", n_inversion_steps=STEPS, n_frames=F,
                  sd_version="tiny", init="random", dtype="f32", guidance_scale=7.5,
                  n_timesteps=N_TIMESTEPS, prompt="a stylized test clip",
                  negative_prompt="ugly", batch_size=2, pnp_attn_t=0.5, pnp_f_t=0.8,
                  image_size=HW)
    base = np.random.default_rng(0).integers(40, 210, (HW, HW, 3), dtype=np.uint8)
    for name in ("one", "two"):
        (tmp_path / name / "data" / "clip").mkdir(parents=True)
        for i in range(F):
            Image.fromarray(np.roll(base, 2 * i, axis=1)).save(
                tmp_path / name / "data" / "clip" / f"{i:05d}.png")
    (tmp_path / "launched.py").write_text(LAUNCHED)

    def run(name, args, launched):
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", str(tmp_path / "launched.py")] if launched
               else [sys.executable, "-m"]) + list(args)
        proc = subprocess.run(cmd, cwd=tmp_path / name, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    (tmp_path / "one" / "pnp.yaml").write_text(yaml.safe_dump(config))
    run("one", pre, False)
    run("one", ["tokenflow_torch.cli.run_pnp", "--config_path", "pnp.yaml"], False)
    logs = [run("two", pre + ["--data_parallel", "2"], True)]
    for cfg_name, extra in (("pnp.yaml", dict(trace_dir="trace")),
                            ("pnp_whole.yaml", dict(shard_pivotal=False,
                                                    output_path="results_whole"))):
        (tmp_path / "two" / cfg_name).write_text(
            yaml.safe_dump(dict(config, data_parallel=2, **extra)))
        logs.append(run("two", ["tokenflow_torch.cli.run_pnp", "--config_path", cfg_name],
                        True))
    for log in logs:
        writes = [json.loads(l.split("RANK_WRITES ", 1)[1]) for l in log.splitlines()
                  if "RANK_WRITES " in l]
        assert writes == [[]], writes  # rank 1 reported, and wrote nothing
        assert "frames group: rank 1 of 2, backend gloo, transport device" in log

    one, two = tmp_path / "one", tmp_path / "two"
    assert len(list((two / "trace").glob("*.pt.trace.json"))) == 1  # rank 0 traced alone
    lat_one, lat_two = _tree(one, "latents"), _tree(two, "latents")
    assert lat_one.keys() == lat_two.keys() and any(k.endswith("trajectory.npz") for k in lat_one)
    for key, path in lat_one.items():
        if key.endswith(".npz"):
            with np.load(path) as a, np.load(lat_two[key]) as b:
                for k in a.files:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-4)
        elif key.endswith(".png"):
            diff = np.abs(np.asarray(Image.open(path), np.int16)
                          - np.asarray(Image.open(lat_two[key]), np.int16))
            assert diff.max() <= 1, key
    want = _tree(one, "results_pnp_SD_tiny")
    for sub in ("results_pnp_SD_tiny", "results_whole_pnp_SD_tiny"):
        got = _tree(two, sub)
        assert got.keys() == want.keys(), sub
        for key, path in want.items():
            if key.endswith(".png"):
                diff = np.abs(np.asarray(Image.open(path), np.int16)
                              - np.asarray(Image.open(got[key]), np.int16))
                assert diff.max() <= 1, (sub, key)
            elif key.endswith("pivots.json"):
                assert json.loads(path.read_text()) == json.loads(got[key].read_text())
            elif key.endswith("config.yaml"):
                a, b = (yaml.safe_load(p.read_text()) for p in (path, got[key]))
                for k in ("data_parallel", "shard_pivotal", "output_path", "trace_dir"):
                    a.pop(k, None)
                    b.pop(k, None)
                assert a == b
            elif key.endswith("metrics.json"):
                assert (json.loads(path.read_text()).keys()
                        == json.loads(got[key].read_text()).keys())

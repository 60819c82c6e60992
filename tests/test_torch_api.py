"""``tokenflow_torch.api`` (the counterpart of ``tokenflow_tpu/api.py``) on
the tiny stack on the CPU, in a fresh subprocess that must never import
JAX or the JAX package: ``invert`` against the preprocess CLI on the same
options, ``edit_pnp`` / ``edit_sdedit`` (exact and vanilla) /
``edit_controlnet`` against their editor CLIs on the same config, each
pair bit for bit (one process, one held stack, the same prompts' ids), and
the TypeError on an unknown preprocess option.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
F, HW = 4, 64

SCRIPT = textwrap.dedent(
    f"""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import yaml
    from tokenflow_torch import api
    from tokenflow_torch.cli import preprocess, run_controlnet, run_pnp, run_sdedit

    flags = dict(data_path="data/clip", H={HW}, W={HW}, init="random", dtype="f32",
                 steps=8, save_steps=4, n_frames={F}, batch_size=2,
                 inversion_prompt="a test clip", device="cpu")
    argv = [a for k, v in flags.items() for a in ("--" + k, str(v))]

    def traj(save_path):
        with np.load(os.path.join(save_path, "latents", "trajectory.npz")) as f:
            return {{k: f[k] for k in f.files}}

    res = {{}}
    inv = {{}}
    for version in ("tiny", "tiny-controlnet"):
        cli = preprocess.main(argv + ["--sd_version", version, "--save_dir", "latents_cli"])
        a = api.invert(sd_version=version, save_dir="latents", **flags)
        inv[version] = traj(a["save_path"])
        res["invert_" + version] = {{
            "equal": all(np.array_equal(v, inv[version][k])
                         for k, v in traj(cli["save_path"]).items()),
            "keys": sorted(a),
        }}
    try:
        api.invert(no_such_option=1)
    except TypeError as e:
        res["type_error"] = str(e)

    base = dict(seed=1, device="cpu", data_path="data/clip", latents_path="latents",
                n_frames={F}, sd_version="tiny", init="random", dtype="f32",
                guidance_scale=7.5, n_timesteps=4, prompt="a stylized test clip",
                negative_prompt="ugly", batch_size=2, image_size={HW})
    pnp = dict(base, n_inversion_steps=8, pnp_attn_t=0.5, pnp_f_t=0.8)
    sdedit = dict(base, start=0.9)
    controlnet = dict(base, n_inversion_steps=8, sd_version="tiny-controlnet")
    runs = (("pnp", run_pnp, pnp, api.edit_pnp, ()),
            ("sdedit", run_sdedit, sdedit, api.edit_sdedit, ()),
            ("vanilla", run_sdedit, sdedit, lambda c: api.edit_sdedit(c, vanilla=True),
             ("--vanilla",)),
            ("controlnet", run_controlnet, controlnet, api.edit_controlnet, ()))
    for name, cli, cfg, fn, extra in runs:
        with open(f"{{name}}.yaml", "w") as f:
            yaml.safe_dump(dict(cfg, output_path="results_cli"), f)
        want = cli.main(["--config_path", f"{{name}}.yaml", *extra])
        out = "api_" + name
        got = fn(dict(cfg, output_path=out))
        res[name] = {{
            "equal": bool(np.array_equal(got, want)),
            "shape": list(got.shape),
            "files": sorted(os.listdir(out)),
            "config": yaml.safe_load(open(os.path.join(out, "config.yaml")))["output_path"],
        }}
    res["foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "flax", "tokenflow_tpu", "transformers"))
    print("RESULT " + json.dumps(res))
    """
)


@pytest.fixture(scope="module")
def run_api(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_api")
    data = root / "data" / "clip"
    data.mkdir(parents=True)
    base = np.random.default_rng(0).integers(40, 210, (HW, HW, 3), dtype=np.uint8)
    for i in range(F):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(data / f"{i:05d}.png")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return root, json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("version", ["tiny", "tiny-controlnet"])
def test_invert_equals_preprocess_cli(run_api, version):
    _, res = run_api
    got = res["invert_" + version]
    assert got["equal"]
    assert {"save_path", "inversion_seconds", "reconstruction_psnr"} <= set(got["keys"])


def test_invert_refuses_unknown_option(run_api):
    _, res = run_api
    assert res["type_error"] == "unknown preprocess option 'no_such_option'"


@pytest.mark.parametrize("name", ["pnp", "sdedit", "vanilla", "controlnet"])
def test_edit_equals_editor_cli(run_api, name):
    """Each facade edit decodes the same frames as its CLI, and writes its
    tree under ``output_path`` as given (no hyperparameter path encoding),
    with the config it ran."""
    root, res = run_api
    got = res[name]
    assert got["equal"] and got["shape"] == [F, HW, HW, 3]
    assert got["config"] == f"api_{name}"
    want = {"vanilla": {"img_ode_vanilla_sde", "vanilla_sde.mp4", "metrics_vanilla.json"}}.get(
        name, {"img_ode", "metrics.json", "pivots.json", "input_fps10.mp4"})
    assert want | {"config.yaml"} <= set(got["files"])


def test_api_never_imports_jax(run_api):
    _, res = run_api
    assert res["foreign"] == []

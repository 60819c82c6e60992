"""The port's own IO modules against the JAX package's: the same token ids,
the same trajectory.npz read both ways, the same frames, the same
normalized depth maps; and no module of tokenflow_torch imports JAX, any
module of the JAX package or ``transformers``.
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

from tokenflow_torch.io import depth as tdepth
from tokenflow_torch.io import latents as tlat
from tokenflow_torch.io import tokenizer as ttok
from tokenflow_torch.io import video as tvid
from tokenflow_tpu.io import depth as jdepth
from tokenflow_tpu.io import latents as jlat
from tokenflow_tpu.io import tokenizer as jtok
from tokenflow_tpu.io import video as jvid

REPO = Path(__file__).resolve().parents[1]

PROMPTS = [
    "a shiny silver robotic wolf",
    "a marble sculpture of a woman running",
    "ugly, blurry, low res",
    "  Hello   WORLD  hello-world 123 ",
    "",
    "word " * 90,  # truncated at 77
]


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    """A small byte-level vocabulary with a few merges, read by both
    CLIPTokenizers."""
    d = tmp_path_factory.mktemp("tok")
    chars = list(jtok._bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = ["h e", "l l", "he ll", "hell o</w>", "w o", "r l", "wo rl",
              "worl d</w>", "c a", "ca t</w>"]
    for m in merges:
        a, b = m.split()
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(d)


@pytest.mark.parametrize("text", PROMPTS)
def test_hash_tokenizer_ids_match_jax(text):
    got = ttok.HashTokenizer(1000)(text)
    assert got == jtok.HashTokenizer(1000)(text)
    assert len(got) == 77


@pytest.mark.parametrize("text", PROMPTS)
def test_clip_tokenizer_ids_match_jax(vocab_files, text):
    got = ttok.CLIPTokenizer.from_pretrained(vocab_files)(text)
    assert got == jtok.CLIPTokenizer.from_pretrained(vocab_files)(text)


def _trajectory(seed):
    rng = np.random.default_rng(seed)
    traj = rng.standard_normal((3, 2, 8, 8, 4)).astype(np.float32)
    final = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return traj, np.asarray([1, 201, 401], np.int32), final, 801


@pytest.mark.parametrize("writer,reader", [(tlat, jlat), (jlat, tlat)],
                         ids=["port_to_jax", "jax_to_port"])
def test_trajectory_npz_reads_across_packages(tmp_path, writer, reader):
    traj, ts, final, final_t = _trajectory(0)
    save_path = writer.save_path_for(str(tmp_path), "2.1", "clip", 8, 2)
    writer.save_trajectory(save_path, traj, ts, final, final_t)
    got = reader.load_trajectory(save_path)
    np.testing.assert_array_equal(got.traj, traj.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(got.final, final.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(got.save_ts, ts)
    assert got.final_t == final_t
    np.testing.assert_array_equal(got.at_timestep(201), got.traj[1])
    found, n = reader.find_latents_path(str(tmp_path), "2.1", "clip", 8, 5, 2)
    assert found == save_path and n == 2


@pytest.mark.parametrize("writer,reader", [(tlat, jlat), (jlat, tlat)],
                         ids=["port_to_jax", "jax_to_port"])
def test_inversion_prompt_reads_across_packages(tmp_path, writer, reader):
    save_path = writer.save_path_for(str(tmp_path), "2.1", "clip", 8, 2)
    os.makedirs(save_path)
    writer.write_inversion_prompt(str(tmp_path), save_path, "clip", "a clip")
    assert reader.read_inversion_prompt(os.path.join(save_path, "latents")) == "a clip"


@pytest.mark.parametrize("hw,resize", [(24, 24), (24, 16), (20, 20)])
def test_load_frames_matches_jax(tmp_path, hw, resize):
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:05d}.png"
        )
    got = tvid.load_frames(str(tmp_path), 3, resize_square=resize)
    want = jvid.load_frames(str(tmp_path), 3, resize_square=resize)
    assert got.shape == (3, resize, resize, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_saved_frames_load_back_alike(tmp_path):
    frames = np.random.default_rng(2).random((2, 16, 16, 3)).astype(np.float32)
    tvid.save_frames(frames, str(tmp_path / "port"))
    jvid.save_frames(frames, str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        tvid.load_frames(str(tmp_path / "port"), 2, 16),
        jvid.load_frames(str(tmp_path / "jax"), 2, 16),
    )


@pytest.mark.parametrize("pred_hw,latent_hw", [((37, 41), (8, 8)), ((384, 384), (64, 64)),
                                               ((6, 6), (16, 12)), ((5, 5), (4, 4))])
def test_normalize_resize_matches_jax(pred_hw, latent_hw):
    """The port's copy of the depth maps' bicubic resize and per-frame
    min-max, bit for bit (a constant map included)."""
    rng = np.random.default_rng(3)
    pred = (rng.random(pred_hw) * 30).astype(np.float32)
    if pred_hw == (5, 5):
        pred[:] = 2.5
    got = tdepth._normalize_resize(pred, latent_hw)
    want = jdepth._normalize_resize(pred, latent_hw)
    assert got.shape == (*latent_hw, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


IMPORT_ALL = textwrap.dedent(
    """
    import importlib, json, pkgutil, sys
    import tokenflow_torch
    names = [m.name for m in pkgutil.walk_packages(
        tokenflow_torch.__path__, prefix="tokenflow_torch.")]
    for name in names:
        importlib.import_module(name)
    print("RESULT " + json.dumps({
        "modules": names,
        "foreign": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "flax", "tokenflow_tpu",
                                                 "transformers")),
    }))
    """
)


def test_port_imports_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    for name in ("cli.run_sdedit", "io.latents", "cli.run_controlnet",
                 "cli.controlnet_utils", "models.controlnet", "ops.editctx",
                 "models.layers", "models.unet2d", "editing.pipeline", "cli.common",
                 "kernels.token_match", "kernels.token_match_split", "models.dpt",
                 "io.depth"):
        assert f"tokenflow_torch.{name}" in result["modules"], name
    assert result["foreign"] == []

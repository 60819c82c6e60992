"""The port's frame-axis sharding (``tokenflow_torch/sharding/mesh.py``, B3's
``flash_attention_sharded`` / ``token_match_gather_sharded``) on gloo
groups of 2 and 3 CPU processes, one case for each case of
tests/test_sharding.py: the edit loop (pivotal pass whole on every rank),
the vanilla loop, windows that straddle the ranks, the sharded pivotal pass
at even and uneven pivot counts (and with fewer pivots than ranks),
``prop_approx`` over a sharded pivotal pass, the single-pass fused step
(every rank runs all the pivots), inversion, VAE encode/decode,
a checkpointed edit killed between segments and resumed, and
``check_divisible``'s errors; and B3's entries on their plain paths.

Every sharded result (gathered on rank 0) is held to the JAX single-device
function on the same numpy-seeded inputs and JAX-initialised weights, and
to the port's single-process run. The ranks are spawned processes
(``tests/torch_sharding_workers.py``, torch only) on a ``file://`` init, so
parallel test workers never share a port; one spawn per world size runs
every case. Tolerance rtol = atol = 1e-4 (tiny UNet, fp32): per-rank batch
sizes change the CPU's summation order by ~1e-6 relative, compounded over
two steps (sharded runs read at most 4e-5 against the port's own
single-process run on the CPU); the inputs keep the matches clear of near ties, as in
tests/test_torch_pipeline.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharding_workers as W
from tokenflow_torch.diffusion import ddim as tddim
from tokenflow_torch.models.weights import state_dict_from_flax
from tokenflow_torch.sharding import mesh
from tokenflow_tpu import runtime as jruntime
from tokenflow_tpu.diffusion import ddim as jddim
from tokenflow_tpu.diffusion import inversion as jinv
from tokenflow_tpu.editing import pipeline as jpipe
from tokenflow_tpu.models import unet2d as junet

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
WORLDS = (2, 3)
SPAWN_SECONDS = 300


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tiny UNet and VAE, the port's copies of their weights, and the
    numpy-seeded inputs every case shares, written for the ranks."""
    root = tmp_path_factory.mktemp("torch_sharding")
    model = junet.UNet2DConditionModel(junet.UNet2DConfig.tiny())
    params = jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, W.HW, W.HW, 4)), jnp.asarray(0),
        jnp.zeros((1, 7, 32)),
    )
    jstack = jruntime.load_stack("tiny", init="random", dtype=jnp.float32,
                                 param_dtype=jnp.float32)
    torch.save({"unet": state_dict_from_flax(params, "unet"),
                "vae": state_dict_from_flax(jstack.vae_params, "vae")},
               root / "weights.pt")
    rng = np.random.default_rng(7)
    inputs = {
        "x0": rng.standard_normal((W.F, W.HW, W.HW, 4)).astype(np.float32),
        "traj": rng.standard_normal((W.STEPS, W.F, W.HW, W.HW, 4)).astype(np.float32) * 0.8,
        "embeds3": rng.standard_normal((3, 7, 32)).astype(np.float32),
        "z": rng.standard_normal((W.F, W.HW, W.HW, 4)).astype(np.float32),
        "frames": rng.uniform(0, 1, (W.F, 32, 32, 3)).astype(np.float32),
    }
    windows = sorted({W.edit_case(c, w)[0] for c in W.EDIT_CASES for w in WORLDS})
    inputs["pivots"] = {
        ws: (rng.integers(0, ws, (W.STEPS, W.F // ws))
             + np.arange(W.F // ws) * ws).astype(np.int32)
        for ws in windows
    }
    torch.save(inputs, root / "inputs.pt")
    unet, stack = W.load_models({"weights": root / "weights.pt"})
    return {"root": root, "model": model, "params": params, "jstack": jstack,
            "inputs": inputs, "unet": unet, "stack": stack, "jax": {}}


@pytest.fixture(scope="module")
def ranks(setup):
    """{world: [rank results]}: one spawn of every case per world size."""
    out = {}
    for world in WORLDS:
        d = setup["root"] / f"world{world}"
        (d / "ckpt").mkdir(parents=True)
        spec = {"world": world, "init": f"file://{d / 'init'}", "out": str(d),
                "inputs": str(setup["root"] / "inputs.pt"),
                "weights": str(setup["root"] / "weights.pt"), "ckpt_dir": str(d / "ckpt")}
        ctx = mp.start_processes(W.run_rank, args=(spec,), nprocs=world, join=False,
                                 start_method="spawn")
        try:
            for _ in range(SPAWN_SECONDS):
                if ctx.join(timeout=1):
                    break
            else:
                raise AssertionError(f"the {world} ranks ran past {SPAWN_SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


def _jax_edit(setup, window, prop_approx, fused=False):
    """The JAX single-device edit loop, cached by geometry."""
    key = ("edit", window, prop_approx, fused)
    if key not in setup["jax"]:
        inputs, model = setup["inputs"], setup["model"]
        sched = jddim.make_schedule(W.STEPS)
        setup["jax"][key] = np.asarray(jpipe.tokenflow_sample_loop(
            lambda p, s, t, c, e: model.apply(p, s, t, c, edit=e),
            setup["params"], jnp.asarray(inputs["x0"]), jnp.asarray(inputs["traj"]),
            jnp.asarray(inputs["embeds3"]),
            jpipe.make_edit_schedule(sched, sched.timesteps[::-1].copy(),
                                     pnp_attn_t=0.5, pnp_f_t=0.8),
            window_size=window, guidance_scale=7.5, pnp=True,
            rng=jax.random.PRNGKey(0),  # unused: pivots pinned
            pivot_indices=setup["inputs"]["pivots"][window], prop_approx=prop_approx,
            fused=fused,
        ))
    return setup["jax"][key]


def _check(got, jax_ref, port_ref):
    got = np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(port_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref), **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", W.EDIT_CASES)
def test_sharded_edit_loop_matches_single_device(setup, ranks, world, case):
    """Each edit case on ``world`` ranks against the JAX single-device loop
    and the port's one-process loop (``torch_sharding_workers.edit_case``
    gives each case's window and switches)."""
    window, switches = W.edit_case(case, world)
    counts = mesh.split_counts(W.F // window, world)
    if case == "pivotal_uneven":
        assert len(set(counts)) == 2 and min(counts) > 0, counts
    if case == "fewer_pivots_than_ranks":
        assert 0 in counts, counts
    if case in ("straddle", "pivotal_uneven", "fused"):
        assert mesh.check_divisible(W.F, world, window) is False  # straddles
    with torch.inference_mode():
        port = W.edit(setup["unet"], setup["inputs"], window, **switches)
    _check(ranks[world][0][case],
           _jax_edit(setup, window, switches["prop_approx"], switches["fused"]), port)
    assert all(r[case] is None for r in ranks[world][1:])  # gathered on rank 0 only


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_vanilla_loop_matches_single_device(setup, ranks, world):
    inputs, model = setup["inputs"], setup["model"]
    sched = jddim.make_schedule(W.STEPS)
    want = jpipe.vanilla_sample_loop(
        lambda p, s, t, c, e, **kw: model.apply(p, s, t, c, edit=e, **kw),
        setup["params"], jnp.asarray(inputs["x0"]), jnp.asarray(inputs["embeds3"][1:]),
        jpipe.make_edit_schedule(sched, sched.timesteps[::-1].copy()),
        guidance_scale=7.5, frame_chunk=2,
    )
    with torch.inference_mode():
        port = W.vanilla(setup["unet"], inputs)
    _check(ranks[world][0]["vanilla"], want, port)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_inversion_matches_single_device(setup, ranks, world):
    inputs, model, params = setup["inputs"], setup["model"], setup["params"]
    cond = jnp.asarray(inputs["embeds3"][2:3])

    def jeps(x, t):
        return model.apply(params, x, t, jnp.broadcast_to(cond, (x.shape[0], *cond.shape[1:])))[0]

    sched = jddim.make_schedule(W.INV_STEPS)
    xj, trj = jax.jit(lambda x: jinv.ddim_inversion(jeps, x, sched, W.INV_STEPS)[:2])(
        jnp.asarray(inputs["x0"] * 0.3))
    with torch.inference_mode():
        x_t, traj, _ = mesh.sharded_inversion(
            W.inversion_eps_fn(setup["unet"], inputs), torch.from_numpy(inputs["x0"]) * 0.3,
            tddim.make_schedule(W.INV_STEPS), W.INV_STEPS)
    got_x, got_traj = ranks[world][0]["inversion"]
    _check(got_x, xj, x_t)
    _check(got_traj, trj, traj)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_vae_matches_single_device(setup, ranks, world):
    """decode_latents / encode_frames over the group (each rank its block,
    rank 0 gathers) against the JAX stack's chunked single-device VAE and
    the port's one-process VAE (tolerance 2e-5, the JAX test's)."""
    inputs, jstack, stack = setup["inputs"], setup["jstack"], setup["stack"]
    tol = dict(rtol=2e-5, atol=2e-5)
    res = ranks[world][0]
    want = np.asarray(jstack.decode_latents(jnp.asarray(inputs["z"]), batch=3))
    port = stack.decode_latents(torch.from_numpy(inputs["z"]), batch=3)
    np.testing.assert_allclose(res["vae_decode"].numpy(), port.numpy(), **tol)
    np.testing.assert_allclose(res["vae_decode"].numpy(), want, **tol)
    want = np.asarray(jstack.encode_frames(jnp.asarray(inputs["frames"]), batch=3))
    port = stack.encode_frames(inputs["frames"], batch=3)
    np.testing.assert_allclose(res["vae_encode"].numpy(), port.numpy(), **tol)
    np.testing.assert_allclose(res["vae_encode"].numpy(), want, **tol)
    assert all(r["vae_decode"] is None for r in ranks[world][1:])


@pytest.mark.parametrize("world", WORLDS)
def test_segmented_checkpoint_resume_on_group(setup, ranks, world):
    """A checkpointed edit over the group, killed between its two segments
    on every rank and resumed: the checkpoint (gathered on rank 0) holds the
    whole carry, every rank restores its block, the resumed run runs the
    second segment only and lands bitwise on the uninterrupted run, and no
    checkpoint is left; that run is the JAX loop's within tolerance."""
    ck = ranks[world][0]["checkpoint"]
    assert ck["segments"] == 2 and ck["killed"] and ck["saved"] and not ck["left"]
    assert all(r["checkpoint"]["resumed_segments"] == 1 for r in ranks[world])
    np.testing.assert_array_equal(ck["resumed"].numpy(), ck["expected"].numpy())
    np.testing.assert_allclose(ck["expected"].numpy(), _jax_edit(setup, 2, False), **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("entry", ["flash_sharded", "match_sharded"])
def test_sharded_kernel_entries_plain_paths(ranks, world, entry):
    """B3's entries on CPU tensors (the plain versions): a rank's query rows
    of ``flash_attention_sharded`` (K/V gathered over uneven keyframe
    blocks, the blockwise path: kv_block below Skv) and a rank's frames of
    ``token_match_gather_sharded`` equal those rows of the unsharded
    functions (rows and frames are independent; 1e-6 for the blockwise
    attention's batch-dependent summation order)."""
    for r in ranks[world]:
        got, want = r[entry]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    bytes_sent = ranks[world][0]["bytes_sent"]
    assert bytes_sent["kv_all_gather"] > 0 and bytes_sent["cache_all_gather"] > 0
    assert ranks[world][1]["group"] == (1, world, "gloo", "device")


def test_check_divisible_errors():
    with pytest.raises(ValueError, match="divide"):
        mesh.check_divisible(12, 8)
    # window misalignment is a perf warning, not an error (BASELINE
    # config 5: 120 frames / 8 devices / window 8 straddles shards)
    assert mesh.check_divisible(8, 8, window_size=2) is False
    assert mesh.check_divisible(16, 8, window_size=2) is True
    assert mesh.split_counts(5, 2) == (3, 2) and mesh.split_counts(2, 3) == (1, 1, 0)


@pytest.mark.parametrize(
    "value,world_size,want",
    [("auto", None, 1), ("off", None, 1), (1, None, 1), ("auto", "2", 2), (2, "2", 2),
     ("2", "2", 2), (2, None, "torchrun"), ("4", "2", "WORLD_SIZE=2"),
     ("off", "2", "data_parallel: off"), ("many", None, "process count"),
     (-1, None, "at least 1")],
)
def test_resolve_world(monkeypatch, value, world_size, want):
    """``data_parallel`` against the launcher's WORLD_SIZE: auto follows it,
    N must equal it (without a launcher the error names torchrun), off is
    one process and refuses a larger world."""
    if world_size is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world_size)
    if isinstance(want, int):
        assert mesh.resolve_world(value) == want
    else:
        with pytest.raises(ValueError, match=want):
            mesh.resolve_world(value)

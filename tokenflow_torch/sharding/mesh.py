"""Frame-axis sharding over ``torch.distributed``, the counterpart of
``tokenflow_tpu/sharding/mesh.py``.

The parallelism model is the JAX package's (mesh.py:1-53). Frames are the
batch axis, and each rank holds a contiguous block of ``F / world`` frames.

- VAE encode/decode, DDIM inversion and reconstruction, the propagation
  pass and the SDEdit vanilla loop run on the rank's own frames. They need
  no communication beyond collecting results on rank 0, which alone writes.
- The pivotal pass is the coupling point. Pivots are global frame indices,
  so ``x[piv]`` and ``src[piv]`` (and ``depth[piv]``, the ControlNet's
  ``cond_image[piv]``) come from the rank that owns each pivot: every rank
  writes its own pivots into a zero buffer and one all-reduce sums the
  buffers (:func:`take_frames`), the all-reduce of the JAX HLO
  (mesh.py:22-25).
- With ``shard_pivotal`` (the default, as in the JAX CLI) the keyframes are
  split over the ranks in contiguous blocks as even as they go
  (:func:`split_counts`: 5 over 2 is 3 and 2; with fewer keyframes than
  ranks a rank holds none). The uncond and cond streams attend over all
  keyframes, so each site all-gathers their K and V along the keyframe axis
  and runs K1 on the rank's queries
  (``kernels/flash_attention.py::flash_attention_sharded``; exact, softmax
  rows are independent). The per-site cache is then all-gathered along the
  keyframe axis, once per site per step (:func:`gather_cache`). Without
  ``shard_pivotal`` every rank runs the whole pivotal pass, and the cache is
  born replicated.
- Propagation runs K2/K3 on the rank's frames against the replicated
  keyframe tables (``kernels/token_match.py::token_match_gather_sharded``).
  The pivot indices stay global, so windows that straddle a shard boundary
  need no exchange, and :func:`check_divisible` only warns about them.

The backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one. gloo with CUDA tensors (two ranks on one card, where NCCL refuses
to run) stages every collective through host memory: the group's
``transport`` is then ``"host"``, else ``"device"``, and the CLIs print it.
Uneven gathers pad each rank's block to the largest and trim in rank order,
which is keyframe order. Every helper takes ``None`` for one process and
then leaves its tensor as it is.

Unlike the JAX package's ``maybe_frames_mesh``, which falls back to one
device when the frames do not divide, :func:`check_divisible` raises: under
N processes a fallback would have every rank run the whole edit.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER = "torchrun --nproc_per_node N (python -m torch.distributed.run)"
_OFF = ("off", "0", 0, False, None)


def resolve_world(data_parallel) -> int:
    """The process count a config's ``data_parallel`` asks for, held to the
    launcher's ``WORLD_SIZE`` (1 without a launcher): ``auto`` is that
    count, ``off`` one process, an integer N must equal it. Raises
    ValueError otherwise, naming the launcher."""
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if data_parallel in _OFF:
        if launched > 1:
            raise ValueError(
                f"data_parallel: off, but the launcher started {launched} processes "
                f"(WORLD_SIZE={launched}); set data_parallel to auto or {launched}"
            )
        return 1
    if data_parallel == "auto":
        return launched
    try:
        if isinstance(data_parallel, bool):
            raise ValueError
        n = int(data_parallel)
    except (TypeError, ValueError):
        raise ValueError(
            f"data_parallel must be auto, off or a process count, got {data_parallel!r}"
        ) from None
    if n < 1:
        raise ValueError(f"data_parallel must be at least 1, got {n}")
    if n != launched:
        if launched == 1:
            raise ValueError(
                f"data_parallel: {n} needs {n} processes, one per rank: start them "
                f"with {LAUNCHER}; this process runs alone (no WORLD_SIZE)"
            )
        raise ValueError(
            f"data_parallel: {n}, but the launcher started {launched} processes "
            f"(WORLD_SIZE={launched})"
        )
    return n


@dataclasses.dataclass
class FramesGroup:
    """The ranks that share one edit's frames, and this rank's place in it.
    ``bytes_sent`` counts, by kind, the bytes this rank contributed to
    collectives (its padded block of each all-gather, its buffer of each
    all-reduce, its block of each gather to rank 0, the source's tensor of
    each broadcast)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    transport: str  # "device": collectives on the tensors; "host": staged in host memory
    bytes_sent: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return (f"[tokenflow-torch] frames group: rank {self.rank} of {self.world}, "
                f"backend {self.backend}, transport {self.transport}, device {self.device}")

    def frame_slice(self, n_frames: int) -> slice:
        """This rank's block of ``n_frames`` frames."""
        per = n_frames // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local(self, x, axis: int = 0):
        """This rank's block of a tensor or array along its frame ``axis``."""
        return x[(slice(None),) * axis + (self.frame_slice(x.shape[axis]),)]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collective takes it, contiguous."""
        return (t.cpu() if self.transport == "host" else t).contiguous()

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.bytes_sent[kind] = self.bytes_sent.get(kind, 0) + t.numel() * t.element_size()


def init_frames_group(rank: int, world: int, device, backend: Optional[str] = None,
                      init_method: str = "env://") -> FramesGroup:
    """Join (or, once initialized, describe) the default process group as
    ``rank`` of ``world`` on ``device``: NCCL for a CUDA device and gloo for
    the CPU unless ``backend`` names one. NCCL refuses two ranks on one GPU,
    so two ranks sharing a card pass ``"gloo"``; their collectives then
    stage through host memory."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices, got {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        atexit.register(_destroy)
    have = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
    if have != (rank, world, backend):
        raise RuntimeError(f"the process group is rank {have[0]} of {have[1]} on "
                           f"{have[2]}, not rank {rank} of {world} on {backend}")
    transport = "host" if device.type == "cuda" and backend == "gloo" else "device"
    return FramesGroup(rank, world, device, backend, transport)


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def frames_group_from_env(data_parallel, device) -> Optional[FramesGroup]:
    """The counterpart of ``tokenflow_tpu/cli/common.py::maybe_frames_mesh``:
    None for one process, else this process's place in the launcher's group
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``, as
    torchrun sets them; a rank on CUDA takes GPU ``LOCAL_RANK`` and NCCL,
    one on the CPU gloo), printed on one line when it starts the group.
    ``data_parallel`` is checked by :func:`resolve_world`; a process group
    already initialized (the editor of ``--then_edit``, a second stage in
    one process) is reused."""
    world = resolve_world(data_parallel)
    if world == 1:
        return None
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has LOCAL_RANK {local}, but "
                               f"{torch.cuda.device_count()} GPUs are visible")
        device = torch.device("cuda", local)
    starts = not dist.is_initialized()
    group = init_frames_group(rank, world, device)
    if starts:
        print(group.describe(), flush=True)
    return group


def check_divisible(n_frames: int, world: int, window_size: int = 1) -> bool:
    """Validate that the frame axis factors over ``world`` ranks
    (``tokenflow_tpu/sharding/mesh.py::check_divisible``, its messages):
    frames that do not divide raise ValueError; windows that straddle shard
    boundaries are correct (the pivot indices are global) and only warn,
    returning False."""
    if n_frames % world:
        raise ValueError(f"n_frames={n_frames} must divide over {world} devices")
    per_dev = n_frames // world
    if window_size > 1 and per_dev % window_size:
        print(
            f"[tokenflow-torch] frames/device={per_dev} is not a multiple of "
            f"window_size={window_size}: propagation windows straddle "
            f"shards (correct, small boundary collectives)",
            flush=True,
        )
        return False
    return True


def split_counts(n: int, world: int) -> tuple[int, ...]:
    """How many of ``n`` keyframes each rank holds, in rank order: blocks
    as even as they go, the larger first (5 over 2: 3 and 2)."""
    return tuple(n // world + (r < n % world) for r in range(world))


def take_frames(group: Optional[FramesGroup], x: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (global frame indices) of the frames whose rank-local
    block is ``x``, on every rank: each rank writes the rows it owns into a
    zero buffer, and one all-reduce sums the buffers (exact: every row has
    one contribution). One process: ``x[idx]``."""
    idx = np.asarray(idx, np.int64)
    if group is None:
        return x[torch.as_tensor(idx, device=x.device)]
    lo = group.rank * x.shape[0]
    mine = np.nonzero((idx >= lo) & (idx < lo + x.shape[0]))[0]
    wire_dev = torch.device("cpu") if group.transport == "host" else x.device
    buf = torch.zeros((len(idx), *x.shape[1:]), dtype=x.dtype, device=wire_dev)
    if len(mine):
        rows = x[torch.as_tensor(idx[mine] - lo, device=x.device)]
        buf[torch.as_tensor(mine, device=wire_dev)] = rows.to(wire_dev)
    group._count("pivot_all_reduce", buf)
    dist.all_reduce(buf)
    return buf.to(x.device)


def all_gather_along(group: Optional[FramesGroup], t: torch.Tensor, axis: int,
                     sizes, kind: str) -> torch.Tensor:
    """Every rank's block of ``t`` along ``axis`` (rank r's holds
    ``sizes[r]`` entries), concatenated in rank order on every rank: each
    block is padded to the largest for the collective, and trimmed after.
    ``kind`` names the bytes in ``group.bytes_sent``."""
    if group is None:
        return t
    if t.shape[axis] != sizes[group.rank]:
        raise ValueError(f"rank {group.rank} holds {t.shape[axis]} entries along axis "
                         f"{axis}, the split says {sizes[group.rank]}")
    wire = group._wire(t)
    pad = max(sizes) - t.shape[axis]
    if pad:
        shape = list(wire.shape)
        shape[axis] = pad
        wire = torch.cat([wire, wire.new_zeros(shape)], dim=axis)
    parts = [torch.empty_like(wire) for _ in range(group.world)]
    group._count(kind, wire)
    dist.all_gather(parts, wire)
    out = torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, sizes)], dim=axis)
    return out.to(t.device)


def gather_cache(group: Optional[FramesGroup], cache: dict, counts) -> dict:
    """The pivotal pass's per-site cache from the rank's keyframes to all
    keyframes (``PivotalShardings.constrain_cache``,
    ``tokenflow_tpu/editing/pipeline.py:70-80``): ``kf_attn`` carries the
    keyframe axis at position 1, every other entry (``pivot_h``,
    ``pivot_h_uncond``, ``conv_src``) leads with it."""
    return {
        site: {key: all_gather_along(group, a, 1 if key == "kf_attn" else 0, counts,
                                     "cache_all_gather")
               for key, a in entry.items()}
        for site, entry in cache.items()
    }


def gather_to_rank0(group: Optional[FramesGroup], t: torch.Tensor,
                    axis: int = 0) -> Optional[torch.Tensor]:
    """The ranks' equal blocks of ``t`` along its frame ``axis``, in rank
    order, on rank 0 (on ``t``'s device); None on the other ranks."""
    if group is None:
        return t
    wire = group._wire(t)
    parts = [torch.empty_like(wire) for _ in range(group.world)] if group.rank == 0 else None
    group._count("gather_to_rank0", wire)
    dist.gather(wire, parts, dst=0)
    return None if parts is None else torch.cat(parts, dim=axis).to(t.device)


def broadcast(group: Optional[FramesGroup], t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (``t``'s device)."""
    if group is None:
        return t
    wire = group._wire(t)
    if group.rank == src:
        group._count("broadcast", wire)
    dist.broadcast(wire, src)
    return wire.to(t.device)


def broadcast_object(group: Optional[FramesGroup], obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src, device=group.device if group.backend == "nccl" else None)
    return box[0]


def barrier(group: Optional[FramesGroup]) -> None:
    if group is not None:
        if group.backend == "nccl":
            dist.barrier(device_ids=[group.device.index])
        else:
            dist.barrier()


def is_writer(group: Optional[FramesGroup]) -> bool:
    """Whether this process writes the outputs: rank 0, or the only one."""
    return group is None or group.rank == 0


def sharded_inversion(eps_fn, latents: torch.Tensor, sched, save_steps: int,
                      group: Optional[FramesGroup] = None, *, segments=None,
                      checkpoint=None):
    """DDIM inversion of the rank's frames ``latents``, the counterpart of
    ``tokenflow_tpu/sharding/mesh.py::sharded_inversion``: inversion is
    embarrassingly frame-parallel, so each rank inverts its own block with
    no communication. ``segments`` (slices of the step indices, default
    one) run in order on one carry, which ``checkpoint`` (a
    ``cli.common.SegmentCheckpointer`` over ``group``, or None) resumes and
    saves at their boundaries. Returns the rank's x_T and trajectory and the
    save grid; :func:`gather_to_rank0` collects them for saving (x_T along
    axis 0, the trajectory along axis 1)."""
    from tokenflow_torch.diffusion import inversion

    segments = segments or [slice(None)]
    traj = torch.zeros((save_steps, *latents.shape), dtype=latents.dtype,
                       device=latents.device)
    start, (x, traj) = (0, (latents, traj)) if checkpoint is None else \
        checkpoint.resume((latents, traj), len(segments))
    save_ts = inversion.inversion_xs(sched, save_steps)[1]
    for i, steps in enumerate(segments):
        if i < start:
            continue
        x, traj, save_ts = inversion.ddim_inversion(
            eps_fn, latents, sched, save_steps, steps=steps, carry=(x, traj))
        if checkpoint is not None:
            checkpoint.save(i, len(segments), (x, traj))
    if checkpoint is not None:
        checkpoint.done()
    return x, traj, save_ts

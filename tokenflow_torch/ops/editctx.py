"""Edit-context types: explicit per-call editing state for the UNet.

PyTorch counterpart of ``tokenflow_tpu/ops/editctx.py``: the two-pass
modes (NONE, PIVOTAL, PROPAGATE), the single-pass FUSED mode and the
approximate (source-free) propagation of ``UNetEdit.prop_approx``. The
directives are plain dataclasses passed as UNet arguments; the UNet returns
the PIVOTAL cache instead of stashing it on modules.

Batch layout: editing passes run the UNet on ``n_streams * n_frames``
items laid out FRAME-MAJOR, item i = (frame i // ns, stream i % ns),
streams [source, uncond, cond] (tokenflow_tpu/ops/editctx.py:7-16), or
[uncond, cond] where the pass is source-free. Stream 0 of a batch always
drives the NN matching.

Over a frames group (``sharding/mesh.py``) only a PIVOTAL directive with
split keyframes carries ``group``: the pass then holds this rank's block
of the keyframes (``kf_counts`` gives every rank's count) and gathers the
extended streams' K/V. A PROPAGATE directive holds this rank's frames
against the replicated cache, and a FUSED one all the keyframes and this
rank's frames; neither needs the group, so neither carries it.

A site is one transformer block (``models/layers.py::block_sites``): SD has
one block at each of its 16 attention sites, SD-XL 70 blocks at 11 sites,
each block a site with its own directive and cache entry. Two counters
(read as K4's and K5's ``launches`` are, by ``scripts/bench_sites.py``):
``sites_visited``, the directives :meth:`UNetEdit.for_site` handed out
(one per block a UNet call runs), and ``pivotal_cache_bytes``, the bytes of
the PIVOTAL caches the UNet returned (:func:`count_cache`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# directives handed to transformer blocks (one per block a UNet call runs)
sites_visited = 0
# bytes of the PIVOTAL caches the UNet returned, every entry's tensors
pivotal_cache_bytes = 0


def count_cache(cache: dict) -> None:
    """Add the bytes of a PIVOTAL cache ({site: {name: tensor}}) to
    ``pivotal_cache_bytes``: shapes and dtypes only, no device sync."""
    global pivotal_cache_bytes
    pivotal_cache_bytes += sum(t.numel() * t.element_size()
                               for entry in cache.values() for t in entry.values())


class EditMode:
    NONE = "none"  # plain UNet (preprocess / vanilla sampling)
    PIVOTAL = "pivotal"  # keyframe pass: extended attention, fills the cache
    PROPAGATE = "propagate"  # propagation pass: NN-gather from the cache
    # one pass for both: the batch is [3*K pivots | 3*F frames], each segment
    # frame-major; at every site the pivots run extended attention into the
    # site's cache and the frames propagate from it at once (the same maths
    # as PIVOTAL then PROPAGATE, tokenflow_tpu/ops/editctx.py:31-37)
    FUSED = "fused"


@dataclasses.dataclass(frozen=True)
class BlockEdit:
    """Directive for one self-attention site in one UNet call."""

    mode: str = EditMode.NONE
    n_frames: int = 1
    n_pivots: int = 0  # FUSED: the keyframes ahead of the frames in the batch
    qk_inject_site: bool = False
    # streams in this pass's frame-major batch: 3 ([source|uncond|cond]),
    # or 2 ([uncond|cond]) in a source-free pass
    n_streams: int = 3
    # PIVOTAL only: also cache the uncond stream's normed states, the
    # matching table of the approximate propagation pass
    cache_uncond: bool = False
    qk_gate: bool = False  # t is in the PnP q/k injection schedule
    pivot_h: Optional[torch.Tensor] = None  # (K, S, D) cached matching states
    kf_attn: Optional[torch.Tensor] = None  # (ns, K, S, D) cached outputs
    prop_pa: Optional[torch.Tensor] = None  # (F,) own-window pivot index
    prop_pb: Optional[torch.Tensor] = None  # (F,) previous-window pivot index
    prop_w1: Optional[torch.Tensor] = None  # (F,) blend weight of prop_pa
    # PIVOTAL only: the sharding.mesh.FramesGroup the keyframes are split
    # over, and the keyframes per rank in rank order
    group: Optional[Any] = None
    kf_counts: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class ConvEdit:
    """Directive for the PnP feature-injection resnet site. Exact mode: the
    uncond/cond streams are overwritten with the source stream after conv2
    when ``gate`` is set. Approximate mode (``approx``): the PIVOTAL pass
    also returns the pivots' source conv2 features as ``{"conv_src": (K, c,
    h, w)}``, and the source-free PROPAGATE pass injects the pa/pb blend of
    those cached features instead."""

    mode: str = EditMode.NONE
    n_frames: int = 1
    n_streams: int = 3
    approx: bool = False
    gate: bool = False
    src_cache: Optional[torch.Tensor] = None  # (K, c, h, w) pivot source conv2
    prop_pa: Optional[torch.Tensor] = None  # (F,)
    prop_pb: Optional[torch.Tensor] = None  # (F,)
    prop_w1: Optional[torch.Tensor] = None  # (F,)


@dataclasses.dataclass(frozen=True)
class UNetEdit:
    """Whole-UNet directive; the UNet fans it out to sites. ``cache`` maps a
    site name to {"pivot_h", "kf_attn"} (plus "pivot_h_uncond" under PnP
    approx, and {"conv_src"} at the conv site) and is read in PROPAGATE
    mode; PIVOTAL mode returns a new cache of that structure.

    ``prop_approx`` (NON-PARITY): the propagation pass drops the source
    stream and runs [uncond|cond]; it matches on the uncond stream against
    the pivots' uncond states and, under PnP, injects the blend of the
    pivots' cached source conv features. Without PnP no stream consumes
    the source, so the pivotal pass is source-free too and its cache is
    born two-stream, led by uncond.

    FUSED: ``n_pivots`` keyframes lead the batch, ``n_frames`` frames
    follow; no cache comes in or goes out, and ``for_conv`` spans both."""

    mode: str = EditMode.NONE
    n_frames: int = 1
    n_pivots: int = 0
    pnp: bool = False
    prop_approx: bool = False
    qk_gate: bool = False
    conv_gate: bool = False
    cache: Optional[dict] = None
    prop_pa: Optional[torch.Tensor] = None
    prop_pb: Optional[torch.Tensor] = None
    prop_w1: Optional[torch.Tensor] = None
    # PIVOTAL only: the frames group the keyframes are split over, and the
    # keyframes per rank (BlockEdit's)
    group: Optional[Any] = None
    kf_counts: Optional[tuple] = None

    def for_site(self, site: str) -> BlockEdit:
        global sites_visited
        sites_visited += 1
        entry = (self.cache or {}).get(site)
        approx_prop = self.prop_approx and self.mode == EditMode.PROPAGATE
        src_free_piv = self.prop_approx and not self.pnp and self.mode == EditMode.PIVOTAL
        if entry is None:
            pivot_h = kf_attn = None
        elif approx_prop and self.pnp:
            # three-stream pivotal cache: match uncond against uncond, gather
            # the [uncond|cond] outputs
            pivot_h, kf_attn = entry["pivot_h_uncond"], entry["kf_attn"][1:]
        else:
            # the exact cache, or the source-free one, already two-stream
            pivot_h, kf_attn = entry["pivot_h"], entry["kf_attn"]
        return BlockEdit(
            mode=self.mode,
            n_frames=self.n_frames,
            n_pivots=self.n_pivots,
            qk_inject_site=self.pnp and site in QK_INJECT_SITES,
            n_streams=2 if (approx_prop or src_free_piv) else 3,
            cache_uncond=self.prop_approx and self.pnp and self.mode == EditMode.PIVOTAL,
            qk_gate=self.qk_gate,
            pivot_h=pivot_h,
            kf_attn=kf_attn,
            prop_pa=self.prop_pa,
            prop_pb=self.prop_pb,
            prop_w1=self.prop_w1,
            group=self.group,
            kf_counts=self.kf_counts,
        )

    def for_conv(self, site: str) -> Optional[ConvEdit]:
        if not self.pnp or site != CONV_INJECT_SITE:
            return None
        entry = (self.cache or {}).get(site)
        approx_prop = self.prop_approx and self.mode == EditMode.PROPAGATE
        # a FUSED batch is [K pivots | F frames], three streams each
        return ConvEdit(
            mode=self.mode,
            n_frames=self.n_frames + self.n_pivots,
            n_streams=2 if approx_prop else 3,
            approx=self.prop_approx,
            gate=self.conv_gate,
            src_cache=None if entry is None else entry["conv_src"],
            prop_pa=self.prop_pa,
            prop_pb=self.prop_pb,
            prop_w1=self.prop_w1,
        )


# PnP q/k injection runs on decoder attention blocks 4-11 only (reference
# tokenflow_utils.py:208-214); all other sites get extended attention only.
QK_INJECT_SITES = frozenset(
    {
        "up_1_1", "up_1_2",
        "up_2_0", "up_2_1", "up_2_2",
        "up_3_0", "up_3_1", "up_3_2",
    }
)

# PnP feature (conv) injection site: second resnet of the first cross-attn
# up block (reference tokenflow_utils.py:102 up_blocks[1].resnets[1]).
CONV_INJECT_SITE = "up_1_res_1"

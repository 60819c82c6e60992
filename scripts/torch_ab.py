"""Parent/change comparison of the PyTorch port on one card.

    python scripts/torch_ab.py PARENT_DIR CHANGE_DIR
        [--what k1 k1f32 m32 k4 sass profile smoke] [--out DIR]

PARENT_DIR and CHANGE_DIR are checkouts of the repo (``git archive``
unpacked into a git-ignored directory). Each measurement runs in the order
parent, change, change, parent, one process per run, with that tree's
``tokenflow_torch`` first on the path and this checkout's ``chip_smoke.py``
helpers (so both trees are measured alike):

  - k1: K1 at ``chip_smoke.K1_SHAPES`` (head dim 64) and
    ``chip_smoke.K1_SD15_SHAPES`` (with their head dims) through the
    tree's ``flash_attention_kernel``, held to its plain version by
    ``chip_smoke.k1_within_limits``: the wrapper's time (``median_ms``),
    one call's device time with host work hidden (``device_ms``) and the
    host's time to enqueue it (``host_ms``);
  - k1f32: K1 in fp32 at ``chip_smoke.K1_F32_SHAPES`` through the tree's
    ``flash_attention_kernel``, held to its plain version by
    ``chip_smoke.k1_f32_mismatch``: the wrapper's time, one call's device
    time and SDPA's in fp32 (TF32 off) on the same tensors;
  - m32: the fp32 match core at ``chip_smoke.K2_F32`` and every other
    ``K2_SHAPES`` site through the tree's K2 wrapper and at
    ``chip_smoke.K3_F32`` through its K3 wrapper, on separated inputs held
    to the plain version by ``chip_smoke._match_verdict``: the wrapper's
    time and one call's device time;
  - k4: K4 at ``chip_smoke.GN_SHAPES`` through the tree's
    ``group_norm_kernel``, held to its plain version by
    ``chip_smoke.gn_verdict``: the wrapper's time (``median_ms``) and one
    call's device time with host work hidden (``device_ms``);
  - sass: ``cuobjdump -sass`` of K1's (``flash_fwd``), the match core's
    (``match_core``) and K5's (``layer_norm_kernel``, not its rotary
    entry ``layer_norm_rope_kernel``) bf16 functions (not the fp32
    ``flash_fwd_f32`` and ``match_core_f32``, nor an older tree's
    ``match_f32``) in the two trees' libraries, compared line by
    line (both listings written to ``sass_{parent,change}.txt``); K1's
    functions are matched by head dim (``flash_fwd_d64`` of a tree from
    before K1 took D as a template parameter is ``flash_fwd<64>``);
  - profile: ``chip_smoke.profile_edit_step`` on the tree's port, device ms
    by kernel class for one 768p SDEdit edit step with K4 on;
  - smoke: the tree's own ``chip_smoke.py`` (its log in the output
    directory), with its phase times, launches and peak memory.

Prints one JSON line per run (``{"ab": ...}``) and appends them all to
``results.jsonl`` in the output directory (``--out``, by default
``build/ab_results`` of this checkout, which git ignores).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ORDER = ("parent", "change", "change", "parent")
SASS_FUNCTIONS = ("flash_fwd", "match_core", "layer_norm_kernel")
# the fp32 kernels (flash_fwd_f32, match_core_f32) are not the bf16 functions
# the comparison holds
SASS_SKIP = ("_f32",)


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke_ab", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_k4(smoke) -> list:
    import torch

    from tokenflow_torch.kernels import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in smoke.GN_SHAPES:
        x, w, b = smoke.gn_inputs(gen, shape)
        for act, eps in (("silu", 1e-5), (None, 1e-6)):
            def call():
                return gn.group_norm_kernel(x, w, b, 32, eps, act)

            v = smoke.gn_verdict(f"[ab K4] {shape} act={act}", call(),
                                 gn.group_norm_plain(x, w, b, 32, eps, act))
            rows.append({"shape": list(shape), "act": act, "ulps": v["ulps"],
                         "wrapper_ms": smoke.median_ms(call),
                         "device_ms": smoke.device_ms(call)})
        del x, w, b
        torch.cuda.empty_cache()
    return rows


def run_k1(smoke) -> list:
    import torch

    from tokenflow_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, sq, skv, h, d in [(*r, 64) for r in smoke.K1_SHAPES] + smoke.K1_SD15_SHAPES:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").bfloat16()
                   for n in (sq, skv, skv))

        def call():
            return fa.flash_attention_kernel(q, k, v)

        m = smoke.k1_mismatch(call(), smoke._k1_plain(fa, q, k, v))
        if not smoke.k1_within_limits(m):
            raise AssertionError(f"K1 at {(b, sq, skv, h, d)}: {m}")
        rows.append({"shape": [b, sq, skv, h], "head_dim": d, **m,
                     "wrapper_ms": smoke.median_ms(call), "device_ms": smoke.device_ms(call),
                     "host_ms": smoke.host_ms(call)})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def run_k1f32(smoke) -> list:
    import torch
    import torch.nn.functional as F

    from tokenflow_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, sq, skv, h, d in smoke.K1_F32_SHAPES:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda")
                   for n in (sq, skv, skv))

        def call():
            return fa.flash_attention_kernel(q, k, v)

        m = smoke.k1_f32_mismatch(call(), fa.flash_attention_plain(q, k, v, kv_block=1024))
        if not smoke.k1_within_limits(m):
            raise AssertionError(f"K1-f32 at {(b, sq, skv, h, d)}: {m}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rows.append({"shape": [b, sq, skv, h, d], **m, "wrapper_ms": smoke.median_ms(call),
                     "device_ms": smoke.device_ms(call),
                     "sdpa_ms": smoke.median_ms(
                         lambda: F.scaled_dot_product_attention(qt, kt, vt))})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def run_m32(smoke) -> list:
    import torch

    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.kernels import token_match_split as tms

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(smoke.K2_F32, tm.token_match_gather_kernel)]
    cases += [(row, tm.token_match_gather_kernel) for row in smoke.K2_SHAPES
              if row != smoke.K2_F32]
    cases += [(smoke.K3_F32, tms.token_match_gather_split_kernel)]
    rows = []
    for (s, d, f, k), kernel in cases:
        args = smoke._match_inputs(gen, s, d, "separated", f, k, dtype=torch.float32)

        def call():
            return kernel(*args)

        ref, ref_idx = tm.token_match_gather_plain(*args, return_indices=True)
        out, *idx = kernel(*args, return_indices=True)
        # K2 returns (2, F, S) indices, K3 ia and ib as (F, 1, S) each
        idx = idx[0] if len(idx) == 1 else torch.stack([i[:, 0] for i in idx])
        smoke._match_verdict("[ab m32]", "separated", idx, ref_idx, out, ref,
                             kf_max=float(args[2].abs().max()))
        rows.append({"shape": [f, s, d], "k": k, "kernel": kernel.__name__,
                     "wrapper_ms": smoke.median_ms(call), "device_ms": smoke.device_ms(call)})
        del args, ref, out
        torch.cuda.empty_cache()
    return rows


def run_one(what: str, tree: str) -> None:
    """One run in this process, with ``tree``'s port first on the path."""
    sys.path.insert(0, tree)
    smoke = _smoke()
    runs = {"k1": run_k1, "k1f32": run_k1f32, "m32": run_m32, "k4": run_k4}
    result = runs[what](smoke) if what in runs else smoke.profile_edit_step()
    print("RESULT " + json.dumps(result), flush=True)


def _sass(tree: Path) -> dict:
    """{function name: SASS lines} of the K1, match-core and K5 functions in the
    tree's kernel library (built here if the tree has none yet). The names
    drop the per-file hashes of their anonymous namespace, which differ
    between checkouts."""
    lib = subprocess.run([sys.executable, "-m", "tokenflow_torch.kernels._build"], cwd=tree,
                         capture_output=True, text=True, check=True).stdout.split()[-1]
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if (any(f in m.group(1) for f in SASS_FUNCTIONS)
                                  and not any(f in m.group(1) for f in SASS_SKIP)) else None
            # K1 by head dim alone: the mangled names of the template
            # flash_fwd<D> and of the older flash_fwd_d64 differ past it
            k1 = name and re.search(r"flash_fwd(?:_d|ILi)(\d+)", name)
            if k1:
                name = f"flash_fwd<{k1.group(1)}>"
            if name:
                funcs[name] = []
        elif name and line.strip().startswith("/*"):  # an instruction line
            # cuobjdump pads the encoding column to the listing's widest line
            funcs[name].append(" ".join(line.split()))
    return funcs


def run_smoke(tree: Path, label: str, i: int, out: Path) -> dict:
    log = out / f"smoke_{i}_{label}.log"
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    lines = log.read_text().splitlines()
    paths = next((json.loads(s) for s in lines if s.startswith('{"main_path"')), None)
    kernels = next((json.loads(s) for s in lines if s.startswith('{"kernels"')), None)
    gn = next((k for k in (kernels or {}).get("kernels", []) if k["name"] == "group_norm"),
              None)
    return {"rc": rc, "log": str(log), "paths": paths,
            "group_norm": gn and {k: gn.get(k) for k in ("ms", "kernel_ms", "launches",
                                                         "launches_by_path")}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", nargs="?")
    parser.add_argument("change", nargs="?")
    parser.add_argument("--what", nargs="+", default=["k4", "sass", "profile", "smoke"],
                        choices=["k1", "k1f32", "m32", "k4", "sass", "profile", "smoke"])
    parser.add_argument("--out", type=Path, default=HERE / "build" / "ab_results",
                        help="directory for results.jsonl and the smoke logs")
    parser.add_argument("--one", nargs=2, metavar=("WHAT", "TREE"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        run_one(*args.one)
        return 0
    trees = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    with open(out / "results.jsonl", "a") as results:
        def emit(record):
            line = json.dumps({"ab": record})
            print(line, flush=True)
            results.write(line + "\n")
            results.flush()

        for what in args.what:
            if what == "sass":
                sass = {label: _sass(tree) for label, tree in trees.items()}
                for label, funcs in sass.items():
                    (out / f"sass_{label}.txt").write_text("\n".join(
                        f"{f}\n" + "\n".join(lines) for f, lines in funcs.items()))
                same = {f: (len(sass["parent"].get(f, [])), len(lines),
                            sass["parent"].get(f) == lines)
                        for f, lines in sass["change"].items()}
                differ = [(f, a, b) for f, lines in sass["change"].items()
                          for a, b in zip(sass["parent"].get(f, []), lines) if a != b]
                emit({"what": "sass", "functions": same, "first_differences": differ[:5],
                      "parent_only": sorted(set(sass["parent"]) - set(sass["change"]))})
                failed |= not same or not all(s[2] for s in same.values())
                continue
            for i, label in enumerate(ORDER):
                tree = trees[label]
                if what == "smoke":
                    record = run_smoke(tree, label, i, out)
                    failed |= record["rc"] != 0
                else:
                    proc = subprocess.run(
                        [sys.executable, str(Path(__file__).resolve()), "--one", what,
                         str(tree)], cwd=tree, capture_output=True, text=True)
                    found = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
                    record = {"rc": proc.returncode,
                              "result": json.loads(found[-1][7:]) if found else None}
                    if proc.returncode:
                        record["stderr"] = proc.stderr[-3000:]
                        failed = True
                emit({"what": what, "tree": label, "run": i, **record})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

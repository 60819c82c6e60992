"""K1-f32's accumulator per KV tile against one accumulation chain, on one card.

    python scripts/k1f32_chain.py [--out FILE]

``csrc/flash_attention_f32.cu`` starts each KV tile's P V from zero in an
accumulator of its own and adds it to O in fp32 registers. This script
copies the port into ``build/k1f32_chain/`` (git-ignored), edits the copy's
kernel so that every tile's P V is chained into O on the tensor cores
instead, and runs both builds, each in a process of its own, on the same
seeded inputs: K1-f32 at D = 64 across Skv, its error against the plain
version (``chip_smoke.k1_f32_mismatch``, limits 2e-5 relative L2 and 1e-4
max|err|) and the wrapper's time. Prints one JSON object per build.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
VARIANT = HERE / "build" / "k1f32_chain"
# (B, S, heads, D): Sq = Skv = S
ROWS = [(2, 1024, 5, 64), (2, 4096, 5, 64), (2, 9216, 5, 64), (2, 20480, 5, 64)]
# the copy's kernel: the three P V products accumulate into O itself, and
# the per-tile accumulator and its add go
CHAIN_EDITS = [
    ("wgmma_tf32_rs<D>(o_t, p_lo[s], v_desc(v_s, 0, s), s);",
     "wgmma_tf32_rs<D>(acc, p_lo[s], v_desc(v_s, 0, s), 1);"),
    ("wgmma_tf32_rs<D>(o_t, p_hi[s], v_desc(v_s, 1, s), 1);",
     "wgmma_tf32_rs<D>(acc, p_hi[s], v_desc(v_s, 1, s), 1);"),
    ("wgmma_tf32_rs<D>(o_t, p_hi[s], v_desc(v_s, 0, s), 1);",
     "wgmma_tf32_rs<D>(acc, p_hi[s], v_desc(v_s, 0, s), 1);"),
    ("fence_regs(o_t);", "fence_regs(acc);"),
    ("#pragma unroll\n      for (int i = 0; i < D / 2; ++i) acc[i] += o_t[i];\n", ""),
    ("    float o_t[D / 2];  // one tile's P V\n", ""),
]


def make_variant() -> Path:
    """The chained copy of the port; raises if an edit no longer applies."""
    shutil.rmtree(VARIANT, ignore_errors=True)
    shutil.copytree(HERE / "tokenflow_torch", VARIANT / "tokenflow_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", VARIANT / "chip_smoke.py")
    src = VARIANT / "tokenflow_torch" / "csrc" / "flash_attention_f32.cu"
    text = src.read_text()
    for old, new in CHAIN_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"the chain edit no longer applies: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return VARIANT


def run_one(tree: str) -> list:
    """Both measurements of ``tree``'s K1-f32, in this process."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("smoke_chain", Path(tree) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from tokenflow_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, h, d in ROWS:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda") for _ in range(3))
        m = smoke.k1_f32_mismatch(fa.flash_attention_kernel(q, k, v),
                                  fa.flash_attention_plain(q, k, v, kv_block=1024))
        rows.append({"shape": [b, s, s, h, d], **m,
                     "within_limits": smoke.k1_within_limits(m),
                     "ms": smoke.median_ms(lambda: fa.flash_attention_kernel(q, k, v))})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, help="also write the results here")
    parser.add_argument("--one", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print("RESULT " + json.dumps(run_one(args.one)), flush=True)
        return 0
    results = []
    for label, tree in (("per_tile", HERE), ("chained", make_variant())):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(tree)], cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} run failed ({proc.returncode}):\n{proc.stderr}")
        rows = json.loads(proc.stdout.split("RESULT ", 1)[1])
        results.append({"accumulator": label, "rows": rows})
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

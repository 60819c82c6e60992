"""Variants of K1's bf16 kernel against the tree's own, on one card.

    python scripts/k1_variants.py [--variants NAME ...] [--out DIR]

The substitutions match the text of the K1 sources of the commit that
added this script, line for line; after a later edit to those lines the
script raises (``variant ...: ... is not in the source``), so run it on a
``git archive`` of that commit, not on a later tree.

Each variant is this tree's ``tokenflow_torch/csrc/flash_attention.cu``
(with ``hopper.cuh`` beside it) under a few text substitutions
(``VARIANTS``), compiled alone into ``build/k1_variants/<name>/`` with the
library's nvcc flags and loaded with ctypes; ``base`` is the source as it
stands. For each variant group the script takes the group's rows
(``ROWS``), holds every variant's output to K1's plain version
(``chip_smoke.k1_within_limits``) and reads one call's device time
(``chip_smoke.device_ms``) three times, base and the variants in turns.
The variants are the designs K1's header comment reports as measured and
not taken:

  - poly8, poly4, poly2: every 8th, 4th or 2nd 8-column group of S takes
    its exponentials on the FMA pipe (a degree-3 minimax polynomial for
    2^f, f in [-0.5, 0.5], the integer part added to the exponent bits)
    instead of MUFU ``ex2``; at every head dim, timed at D = 40;
  - d40_2c_bn128, d40_2c_bn192, d40_2c_bn256: D = 40 with two consumer
    warpgroups (240 registers each) and 128-, 192- or 256-token KV tiles;
  - d80_3c_bn64, d80_3c_bn96, d80_3c_bn128: D = 80 with three consumers
    and 64-, 96- or 128-token tiles (5, 3 or 2 stages);
  - d160_2c, d160_3c: D = 160 always on its two- or three-consumer plan,
    timed at 5 and 4 keyframes at 512^2 (16^2 level), at the two ranks'
    queries of a 2-rank frames group with shard_pivotal (3 and 2
    keyframes) and at the ragged row;
  - noturn: the consumers issue their products without taking turns;
  - desc: each operand's wgmma descriptor computed once per tile, each
    k-step adding its offset / 16.

The variants build under ``build/k1_variants/``. Prints one JSON line per
reading and appends them to ``results.jsonl`` in ``--out`` (default
``build/k1_variants``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

EX2_POLY = """
// 2^x for x <= 0 on the FMA pipe: x = j + f, j = round(x) (the 1.5 * 2^23
// shifter), f in [-0.5, 0.5]; 2^f by a degree-3 minimax polynomial
// (relative error 7.5e-5); j added to the exponent bits; x clamped at -125
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -125.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517167f, f, 0.24261113f), f, 0.69326097f), f,
                       0.99992806f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(r) << 23));
}
"""
EX2_ANCHOR = "// The online softmax of one KV tile"
EXP_OLD = "        x = ex2(fmaf(x, scale_log2, -mn));"
QK_OLD = """        if constexpr (kBN == 128)
          wgmma_m64n128k16_ss(sc, da, db, kk);
        else
          wgmma_m64n64k16_ss(sc, da, db, kk);"""
QK_NEW = """        if constexpr (kBN == 256) wgmma_m64n256k16_ss(sc, da, db, kk);
        else if constexpr (kBN == 192) wgmma_m64n192k16_ss(sc, da, db, kk);
        else if constexpr (kBN == 128) wgmma_m64n128k16_ss(sc, da, db, kk);
        else if constexpr (kBN == 96) wgmma_m64n96k16_ss(sc, da, db, kk);
        else wgmma_m64n64k16_ss(sc, da, db, kk);"""
BN_OLD = "kBN = D <= 128 ? 128 : 64;"
STAGES_OLD = "kStages = D <= 64 ? 4 : 3;"
WRAPPER_ANCHOR = "// named barrier `id` between two consumer warpgroups"


def ss_wrapper(n: int) -> str:
    """The wgmma m64nNk16 product with both operands in shared memory."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (
        f"__device__ __forceinline__ void wgmma_m64n{n}k16_ss(float (&d)[{r}], "
        "uint64_t da, uint64_t db, int accumulate) {\n"
        f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'      "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f'      : {outs}\n      : "l"(da), "l"(db), "r"(accumulate));\n}}\n\n'
    )


def poly(every: int) -> list:
    return [(EX2_ANCHOR, EX2_POLY + "\n" + EX2_ANCHOR),
            (EXP_OLD, f"        x = n % {every} == {every - 1} ? "
                      "ex2_poly(fmaf(x, scale_log2, -mn)) : ex2(fmaf(x, scale_log2, -mn));")]


def plan(d: int, consumers: int, default: int, bn: int, stages: int) -> list:
    """Head dim d on `consumers` warpgroups (its launch) with bn-token tiles
    in `stages` stages."""
    return [(f"case {d}: return launch<{d}, {default}>",
             f"case {d}: return launch<{d}, {consumers}>"),
            (BN_OLD, f"kBN = D == {d} ? {bn} : D <= 128 ? 128 : 64;"),
            (STAGES_OLD, f"kStages = D == {d} ? {stages} : D <= 64 ? 4 : 3;"),
            (QK_OLD, QK_NEW)]


VARIANTS = {
    "base": [],
    "poly8": poly(8), "poly4": poly(4), "poly2": poly(2),
    "d40_2c_bn128": plan(40, 2, 3, 128, 4),
    "d40_2c_bn192": plan(40, 2, 3, 192, 4),
    "d40_2c_bn256": plan(40, 2, 3, 256, 3),
    "d80_3c_bn64": plan(80, 3, 2, 64, 5),
    "d80_3c_bn96": plan(80, 3, 2, 96, 3),
    "d80_3c_bn128": plan(80, 3, 2, 128, 2),
    "d160_2c": [("return d160_two_consumers(batch, heads, sq, sm_count(dev))",
                 "return true")],
    "d160_3c": [("return d160_two_consumers(batch, heads, sq, sm_count(dev))",
                 "return false")],
    "noturn": [("    auto take_turn = [&] { named_bar_sync(my_turn); };",
                "    auto take_turn = [&] {};"),
               ("      if (wg < kConsumers - 1 || ++turn < n_turns) named_bar_arrive(next_turn);",
                "      (void)turn; (void)n_turns; (void)next_turn; (void)my_turn;"),
               ("    if (wg == kConsumers - 1) named_bar_arrive(next_turn);\n", "")],
    "desc": [("""    auto mma_qk = [&](int j) {
      const uint32_t k_s = base + C::kOffK + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        const uint64_t da = kmajor_desc(q_s + (kk / 4) * C::kQBoxBytes + (kk % 4) * 32);
        const uint64_t db = kmajor_desc(k_s + (kk / 4) * kBoxBytes + (kk % 4) * 32);""",
              """    auto kstep = [](int kk, uint32_t box_bytes) -> uint64_t {
      return ((kk / 4) * box_bytes + (kk % 4) * 32) >> 4;
    };
    const uint64_t q_desc = kmajor_desc(q_s);
    auto mma_qk = [&](int j) {
      const uint64_t k_desc = kmajor_desc(base + C::kOffK + (j % kStages) * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        const uint64_t da = q_desc + kstep(kk, C::kQBoxBytes);
        const uint64_t db = k_desc + kstep(kk, kBoxBytes);"""),
             ("""      const uint32_t v_s = base + C::kOffV + (j % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], mnmajor_desc(v_s + kk * 16 * kRowBytes, kAtomBytes));""",
              """      const uint64_t v_desc =
          mnmajor_desc(base + C::kOffV + (j % kStages) * kTileBytes, kAtomBytes);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], v_desc + kk * 16 * kRowBytes / 16);""")],
}
D40 = [(2, 20480, 20480, 8, 40), (40, 4096, 4096, 8, 40)]
ONE_PER_D = [(2, 20480, 20480, 5, 64), (2, 20480, 20480, 8, 40), (2, 5120, 5120, 8, 80),
             (2, 1280, 1280, 8, 160)]
# (B, Sq, Skv, H, D) timed for each variant (and base beside it)
ROWS = {
    **{v: D40 for v in ("poly8", "poly4", "poly2", "d40_2c_bn128", "d40_2c_bn192",
                        "d40_2c_bn256")},
    **{v: [(2, 5120, 5120, 8, 80)] for v in ("d80_3c_bn64", "d80_3c_bn96", "d80_3c_bn128")},
    **{v: [(2, 1280, 1280, 8, 160), (2, 1024, 1024, 8, 160), (2, 768, 1280, 8, 160),
           (2, 512, 1280, 8, 160), (2, 1000, 3000, 5, 160)] for v in ("d160_2c", "d160_3c")},
    "noturn": ONE_PER_D, "desc": ONE_PER_D + [(40, 4096, 4096, 8, 40)],
}
READINGS = 3
BUILD_DIR = HERE / "build" / "k1_variants"


def build(names: list, out: Path) -> dict:
    """{name: (ctypes library, ptxas spill lines)} of each variant, compiled
    together, one nvcc process each."""
    from tokenflow_torch.kernels import _build

    nvcc = _build.find_nvcc()
    wrappers = "".join(ss_wrapper(n) for n in (96, 192, 256))
    jobs = {}
    for name in names:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        hopper = src / "hopper.cuh"
        hopper.write_text(hopper.read_text().replace(WRAPPER_ANCHOR, wrappers + WRAPPER_ANCHOR))
        cu = src / "flash_attention.cu"
        text = cu.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(src), str(cu),
               "-o", str(src / "lib.so")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.tf_flash_attention.argtypes = _build.SIGNATURES["tf_flash_attention"]
        lib.tf_error_string.argtypes = [ctypes.c_int]
        lib.tf_error_string.restype = ctypes.c_char_p
        spills = [line.split("info    :")[-1].strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores" not in line]
        libs[name] = (lib, spills)
    return libs


def launch(lib, q, k, v):
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    rc = lib.tf_flash_attention(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, k.shape[1],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], d**-0.5,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(lib.tf_error_string(rc).decode())
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=[v for v in VARIANTS if v != "base"],
                        choices=[v for v in VARIANTS if v != "base"])
    parser.add_argument("--out", type=Path, default=BUILD_DIR)
    args = parser.parse_args()
    import torch

    from tokenflow_torch.kernels import flash_attention as fa

    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants.py needs a CUDA card")
    args.out.mkdir(parents=True, exist_ok=True)
    print(smoke.card_line(), flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = build(["base", *args.variants], BUILD_DIR)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = sorted({row for v in args.variants for row in ROWS[v]})
    with open(args.out / "results.jsonl", "a") as results, \
            smoke.watchdog(1800, "the K1 variants"):
        for b, sq, skv, h, d in shapes:
            q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").bfloat16()
                       for n in (sq, skv, skv))
            ref = smoke._k1_plain(fa, q, k, v)
            bound = 4.0 * b * h * sq * skv * d / smoke.H100_BF16_FLOPS * 1e3
            names = ["base"] + [n for n in args.variants if (b, sq, skv, h, d) in ROWS[n]]
            for reading in range(READINGS):
                for name in names:
                    lib, spills = libs[name]
                    m = smoke.k1_mismatch(launch(lib, q, k, v), ref)
                    ms = smoke.device_ms(lambda: launch(lib, q, k, v))
                    line = json.dumps({"variant": name, "reading": reading,
                                       "shape": [b, sq, skv, h, d], "device_ms": ms,
                                       "bound_share": bound / ms,
                                       "within_limits": smoke.k1_within_limits(m),
                                       "rel_l2": m["rel_l2"], "spills": spills})
                    print(line, flush=True)
                    results.write(line + "\n")
            del q, k, v, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that set a cell's output limits: the program's compared
numbers over many seeds, and the control's (the reference in fp8 in the
program's place) over some, at the cell's own size, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 10] --out chiprun_out/<file>.json

Each seed is one run of the cell (a window of ``run_seconds`` unless
``--seconds`` says otherwise, its own weights and inputs) and prints one
JSON line; ``--out`` gets them all."""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cell = manifest.cell(a.workload)
    seconds = manifest.benchmark()["run_seconds"] if a.seconds is None else a.seconds
    harness.cache_dirs(HERE.parent)
    import torch

    controls = {int(s) for s in a.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        args = harness.parse(["--workload", a.workload, "--seed", str(seed),
                              "--seconds", str(seconds)])
        out = harness.run_cell(cell, args, time.monotonic(), HERE, torch.device("cuda", 0),
                               control="fp8" if seed in controls else None)
        row = {"seed": seed, "steps": out["steps"], "window_s": out["window_s"],
               "reference_s": out["reference_s"], "sound": out["compared"],
               "control": out.get("control")}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"workload": a.workload, "card": harness.card_line(),
                                           "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

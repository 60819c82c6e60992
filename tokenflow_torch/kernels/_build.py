"""Build and load the hand-written CUDA kernels (``tokenflow_torch/csrc``).

All ``csrc/*.cu`` files compile with ``nvcc``, one process per source, all
started together, and link into ONE shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The library lands in ``build/tokenflow_torch/`` at the repo
root, named by a content hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing here runs at
import time: the first kernel launch builds.

``python -m tokenflow_torch.kernels._build --ptxas [CSRC_DIR]`` compiles
each source of a ``csrc`` directory (this package's by default) with the
same flags plus ``-Xptxas -v`` and prints every kernel's registers, shared
memory, stack frame and spills, one line per kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import os
import shutil
import re
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tokenflow_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-lineinfo",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the exported launchers (every pointer and the stream as a
# void pointer, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "tf_flash_attention": [_I] + [_P] * 4 + [_I] * 4 + [_L] * 12
    + [ctypes.c_float, _P],
    "tf_flash_attention_f32": [_I] + [_P] * 4 + [_I] * 4 + [_L] * 12
    + [ctypes.c_float, _P, _P],
    "tf_flash_attention_f32_workspace": [_I] * 5,
    "tf_flash_attention_plan": [_I] * 5 + [ctypes.POINTER(_I)],
    "tf_short_attention": [_I] + [_P] * 4 + [_I] * 4 + [_L] * 12
    + [ctypes.c_float, _P],
    "tf_token_match": [_P] * 8 + [_I] * 5 + [_P],
    "tf_token_match_split": [_P] * 9 + [_I] * 5 + [_P],
    "tf_token_match_f32": [_P] * 9 + [_I] * 5 + [_P, _P],
    "tf_token_match_f32_workspace": [_I] * 4,
    "tf_group_norm": [_P] * 5 + [_I] * 4 + [_L, _I] + [_L] * 3
    + [ctypes.c_float, _I, _P],
    "tf_group_norm_occupancy": [_I] * 3 + [_L, _I] + [_L] * 2 + [_P] * 2,
    "tf_layer_norm": [_P] * 4 + [_L] + [_I] * 3 + [ctypes.c_float, _P],
    "tf_layer_norm_rope": [_P] * 6 + [_L] + [_I] * 5 + [ctypes.c_float, _P],
    "tf_geglu_gemm": [_P] * 4 + [_I] * 4 + [_P],
}
# return types other than int: the workspace sizes in bytes
RESTYPES = {
    "tf_flash_attention_f32_workspace": _L,
    "tf_token_match_f32_workspace": _L,
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built on this machine"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtokenflow_kernels_{source_hash()}.so"


def _compile_all(nvcc: str, csrc: Path, out_dir: str, extra=()) -> list:
    """Compile every ``*.cu`` of ``csrc`` into ``out_dir``, one nvcc process
    per source, all started together; returns (object, nvcc output) pairs
    and raises with every failed compile's output."""
    jobs = []
    for cu in sorted(csrc.glob("*.cu")):
        obj = os.path.join(out_dir, cu.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(csrc), "-c", str(cu), "-o", obj]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    done, failed = [], []
    for obj, cmd, proc in jobs:  # wait for every compile before raising
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        done.append((obj, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def ptxas_report(csrc: Path = CSRC) -> list[str]:
    """One line per kernel of ``csrc``: source, kernel (mangled name),
    registers, shared memory, stack frame and spill bytes, and any wgmma
    serialisation warning, from nvcc's ``-Xptxas -v``."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for obj, log in _compile_all(find_nvcc(), Path(csrc), tmp, ("-Xptxas", "-v")):
            kernel = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    kernel = m.group(1)
                elif kernel and any(k in line for k in ("stack frame", "Used", "wgmma")):
                    text = line.split("info    :")[-1].strip()
                    lines.append(f"{Path(obj).stem} {kernel}: {text}")
    return lines


def build() -> Path:
    """Compile the library unless an up-to-date one exists; return its
    path. A failed compile raises with nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a private directory, then rename: concurrent builders never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [obj for obj, _ in _compile_all(nvcc, CSRC, tmp)]
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", lib, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(lib, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    lib.tf_error_string.argtypes = [ctypes.c_int]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} "
            f"({lib.tf_error_string(rc).decode(errors='replace')})"
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ptxas", nargs="?", const=str(CSRC), metavar="CSRC_DIR",
                        help="print -Xptxas -v resource usage of each kernel")
    args = parser.parse_args()
    if args.ptxas:
        print("\n".join(ptxas_report(Path(args.ptxas))))
    else:
        print(build())
    sys.exit(0)

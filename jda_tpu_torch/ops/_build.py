"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` into
a shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source and of every header
(`csrc/*.cuh`) beside it, so an edited source or header builds anew and a
stale library is never loaded.  Builds happen at first use,
never at import.  `build_all` starts one nvcc per source, all at once;
the sources one detection path loads at its first call (a group of
`BUILT_TOGETHER`) are built together at the first load of any of them.
The loaded libraries are the package's only module-level state.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the sources each detection path loads: the dense stage-0 filter and the
# survivor tail (a fused call), the o/h/q pyramid and the tail's level walk
# (a multi-scale model's non-fused call, which loads the pyramid first)
BUILT_TOGETHER = (("dense0", "tail"), ("pyramid", "tail"))

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of jda_tpu_torch are built from csrc/ at first use"
    )


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    if not os.path.exists(src):
        raise RuntimeError(f"kernel source missing: {src}")
    sha = hashlib.sha1()
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together.  Returns name -> .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        src, so = _paths(name)
        out[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        procs[name] = (
            subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            so,
        )
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed with
    the rest of the first group of BUILT_TOGETHER that holds it, and the
    whole group loaded."""
    if name not in _libs:
        group = next((g for g in BUILT_TOGETHER if name in g), (name,))
        for n, path in build_all(group).items():
            if n not in _libs:
                _libs[n] = ctypes.CDLL(path)
    return _libs[name]

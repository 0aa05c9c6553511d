"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``repro_torch/csrc/`` compiles into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/kernels/`` at the repository root, named by a hash
of the source and the flags, and is reused until either changes.  Nothing
is built when this module is imported: the first kernel launch builds what
it needs, and ``build_all`` builds every source at once, one ``nvcc``
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"fed_agg": "fed_agg.cu", "robust_agg": "robust_agg.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Build(NamedTuple):
    """One built library: its path, the seconds ``nvcc`` took in this
    process (0.0 when the library was already built) and the compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    path: Path
    seconds: float
    report: str


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels can only be built where the CUDA "
                       "toolkit is installed")


def lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None) -> Dict[str, Build]:
    """Build every named source that has no library yet, in parallel.

    Raises ``RuntimeError`` with the compiler's output if any build
    fails.  Returns ``{name: Build}`` for every requested name."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Build] = {}
    running = {}
    for name in names:
        path = lib_path(name)
        log = path.with_suffix(".log")
        if path.exists():
            report = log.read_text() if log.exists() else ""
            out[name] = Build(path, 0.0, report)
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, log, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, log, t0) in running.items():
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{report}")
            continue
        log.write_text(report)
        os.replace(tmp, path)        # atomic: concurrent builders agree
        out[name] = Build(path, seconds, report)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    return ctypes.CDLL(str(build_all([name])[name].path))


class LaunchCounter:
    """Plain-integer count of one kernel's launches.  A wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0

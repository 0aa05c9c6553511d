"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``repro_torch/csrc/`` compiles into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds); the
scan kernels share ``csrc/mma.cuh``.  The library lands in ``build/kernels/`` at the repository root, named by a hash
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
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"fed_agg": "fed_agg.cu", "robust_agg": "robust_agg.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "ssm_scan": "ssm_scan.cu", "ssm_scan_bwd": "ssm_scan_bwd.cu",
           "rwkv6_scan": "rwkv6_scan.cu",
           "rwkv6_scan_bwd": "rwkv6_scan_bwd.cu"}
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
    """Where the library of one source goes: named by a hash of the source,
    the headers beside it (``csrc/*.cuh``) and the flags."""
    src = CSRC / SOURCES[name]
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text
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


class KernelReport(NamedTuple):
    """What ``ptxas -v`` says of one entry function: registers at launch
    and bytes spilled."""
    registers: int
    spill_stores: int
    spill_loads: int


def ptxas_kernels(report: str) -> Dict[str, KernelReport]:
    """Each entry function of a ``-Xptxas -v`` report, by mangled name."""
    out: Dict[str, KernelReport] = {}
    name, spills = None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = KernelReport(int(m.group(1)), *spills)
            name = None
    return out


def ptxas_warnings(report: str) -> List[str]:
    """The warning lines of a ``-Xptxas -v`` report (e.g. wgmma
    serialisation, an ignored ``setmaxnreg``)."""
    return [line.strip() for line in report.splitlines()
            if "warning" in line.lower()]


def wgmma_serialised(report: str) -> List[str]:
    """The lines of a ``-Xptxas -v`` report saying ptxas serialised wgmma
    instructions (it prints some as "info", C7512, some as warnings)."""
    return [line.strip() for line in report.splitlines()
            if "wgmma" in line and "serializ" in line]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    return ctypes.CDLL(str(build_all([name])[name].path))


class LaunchCounter:
    """Plain-integer count of one kernel's launches.  A wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel.  A kernel with several
    variants also counts each in ``by_variant`` (``count`` is their
    total); the dict is reset in place, so a reference to it stays
    live."""

    def __init__(self, variants=()):
        self.count = 0
        self.by_variant = {v: 0 for v in variants}

    def add(self, variant=None):
        if variant is not None:
            self.by_variant[variant] += 1
        self.count += 1

    def reset(self):
        self.count = 0
        for v in self.by_variant:
            self.by_variant[v] = 0


"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
into its own shared library for ``sm_90a`` at first use and loaded with
``ctypes``: no PyTorch headers are compiled, which keeps a cold build to
seconds. Libraries land in ``build/kernels/`` at the repository root (listed
in ``.gitignore``), named by a hash of their source and of every header
under ``csrc/``, so an edited source or header is never served by a stale
build. Sources are compiled in parallel, one ``nvcc`` each. A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
KERNELS = ("conv3d", "conv3d_variants", "conv3d_s8_strided", "conv_int8", "flash_attention",
           "flash_attention_bwd", "ring_attention")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc/ptxas output of this process's builds


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit",
    )


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    text = b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, all at
    once. Returns the seconds each build took (0.0 when it was cached)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(code: int, lib: ctypes.CDLL, error_fn: str, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, error_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: CUDA error {code} ({fn(code).decode()})")

"""Native (C++) host-pipeline components, bound via ctypes.

The port's copy of ``rho_diffusion_tpu/native``: the spherical-harmonics
field generator ``ylm.cpp``, host code that feeds the data pipeline (no
device kernel). The library is built with g++ on first use into
``build/native/`` at the root of the checkout (its name carries a hash of
the source, so an edited source builds anew), never next to the sources.
With no toolchain ``get_ylm_lib`` returns None and every consumer takes its
scipy path, so the package works the same without one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ylm.cpp"
# the JAX package's build line, so that both libraries compute the same bits
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "native"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return build_dir() / f"libylm-{digest[:16]}.so"


def _build() -> Optional[Path]:
    """The library, compiled unless it exists; None without a toolchain.
    Compiles to a temporary name and renames, so concurrent processes never
    load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def get_ylm_lib() -> Optional[ctypes.CDLL]:
    """The compiled ylm library, built on first use; None when no toolchain
    is available (callers take the scipy path)."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ylm_field.argtypes = [dp, dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, fp]
    lib.ylm_field.restype = ctypes.c_int
    lib.ylm_field_ex.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, fp,
    ]
    lib.ylm_field_ex.restype = ctypes.c_int
    lib.ylm_fields.argtypes = [dp, dp, dp, ctypes.c_int, ip, ip, ctypes.c_int, fp]
    lib.ylm_fields.restype = ctypes.c_int
    return lib


def ylm_field_native(
    x: np.ndarray, y: np.ndarray, z: np.ndarray, m: int, l: int,  # noqa: E741
    normalize: bool = True,
) -> Optional[np.ndarray]:
    """Native |Y_lm * r| field on the meshgrid of the cubic axes x, y, z;
    None if the library is unavailable.

    ``normalize=True`` applies the reference's complex lexicographic min-max
    normalisation. That normalisation is ill-conditioned: symmetric grids
    give exact real-part ties in the complex ordering, so a 1e-15
    perturbation can flip which point is "min" and shift the whole field,
    and the scipy path and the native path may differ for tie-affected
    (l, m). The unnormalised field agrees with scipy to ~1e-16."""
    lib = get_ylm_lib()
    if lib is None:
        return None
    n = len(x)
    if len(y) != n or len(z) != n:
        raise ValueError(f"the native path expects a cubic grid, got {len(x)}, {len(y)}, {len(z)}")
    out = np.empty(n * n * n, np.float32)
    rc = lib.ylm_field_ex(
        np.ascontiguousarray(x, np.float64),
        np.ascontiguousarray(y, np.float64),
        np.ascontiguousarray(z, np.float64),
        n, int(l), int(m), int(normalize), out,
    )
    if rc != 0:
        raise ValueError(f"ylm_field failed with code {rc} (l={l}, m={m})")
    return out.reshape(n, n, n)

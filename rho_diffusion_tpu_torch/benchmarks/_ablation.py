"""Source variants of one kernel for the ablation entries: a copy of
``csrc/`` for each variant with some text of one source replaced, each
compiled with the port's own ``nvcc`` flags, one ``nvcc`` a variant, all
started together."""
from __future__ import annotations

import ctypes
import shutil
import subprocess

from rho_diffusion_tpu_torch.ops.kernels import _build


def patched(text: str, edits, source: str) -> str:
    """``text`` (the file ``source``) with each edit (old, new, count) made,
    each found exactly as often as it says, so a kernel that has moved on
    fails loudly here."""
    for old, new, count in edits:
        found = text.count(old)
        if found != count:
            raise ValueError(f"{old!r} occurs {found} times in {source}, not {count}")
        text = text.replace(old, new)
    return text


def build_variants(variants: dict, source: str, target: str, launchers: dict,
                   out_dir) -> tuple[dict, dict]:
    """({variant: loaded library}, {variant: its nvcc output}): for each of
    ``variants`` ({name: edits of csrc/<source>}) csrc/ copied with the
    edits and csrc/<target>.cu compiled into a library whose ``launchers``
    ({function: argtypes}) get their signatures."""
    text = (_build.CSRC / source).read_text()
    procs = {}
    for name, edits in variants.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        (src / source).write_text(patched(text, edits, source))
        lib = src / f"lib{target}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{target}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in launchers.items():
            getattr(libs[name], fn).restype = ctypes.c_int
            getattr(libs[name], fn).argtypes = argtypes
    return libs, logs

"""Profiling, tracing and failure-detection utilities.

Port of ``rho_diffusion_tpu/training/profiling.py``:

* ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when the card is there) that writes a chrome
  trace (``*.pt.trace.json``, viewable in Perfetto or TensorBoard's
  PyTorch plugin) into ``logdir`` when the block ends;
* ``StepTimer``: wall-clock step statistics (median/p90, steps/sec), the
  JAX package's keys;
* ``compiled_cost``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``, with a convolution counted
  as XLA's cost analysis counts it (only the products whose input lies
  inside the unpadded input);
* ``find_nonfinite`` / ``check_finite``: the paths of NaN/Inf leaves in
  nested dicts, lists, tuples, tensors and state_dicts, written as
  ``jax.tree_util.keystr`` writes them for the same nesting.
"""
from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the block into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) \
            as prof:
        yield prof


class StepTimer:
    """Accumulates per-step wall-clock times; cheap enough for every step."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def stats(self, skip_first: int = 1) -> dict[str, float]:
        ts = np.asarray(self.times[skip_first:] or self.times or [0.0])
        return {
            "median_step_s": float(np.median(ts)),
            "p90_step_s": float(np.percentile(ts, 90)),
            "steps_per_sec": float(1.0 / max(np.median(ts), 1e-12)),
            "n_steps": int(len(ts)),
        }


def _in_bounds_taps(n: int, k: int, out: int, stride: int, pad: int, dilation: int) -> int:
    """(output position, kernel tap) pairs of one dimension whose input
    index lies inside the unpadded input."""
    return sum(1 for j in range(k) for i in range(out) if 0 <= i * stride + j * dilation - pad < n)


def _conv_flops(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
                out_shape=None, **kwargs) -> int:
    """aten.convolution's products counted as XLA counts them: two FLOPs
    per product of an output element and an in-bounds input element."""
    if transposed:
        from torch.utils.flop_counter import conv_flop

        return conv_flop(x_shape, w_shape, _bias, stride, padding, dilation, transposed,
                         out_shape=out_shape)
    spatial = math.prod(
        _in_bounds_taps(n, k, o, s, p, d)
        for n, k, o, s, p, d in zip(x_shape[2:], w_shape[2:], out_shape[2:], stride, padding,
                                    dilation))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * spatial


def compiled_cost(fn, *args, **kwargs) -> dict[str, float]:
    """FLOPs of one call ``fn(*args, **kwargs)``, and ``bytes_accessed``.

    torch has no counterpart of XLA's estimate of the bytes a compiled
    program accesses, so ``bytes_accessed`` is NaN: what the JAX function
    returns when the cost analysis lacks the key."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    mapping = {aten.convolution: _conv_flops, aten._convolution: _conv_flops}
    with torch.no_grad(), FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) in jax.tree_util's order: dict keys sorted,
    sequences by index, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_path(sub, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def find_nonfinite(tree: Any) -> list[str]:
    """Paths of the leaves holding NaN/Inf (each leaf read on the host)."""
    return [path for path, leaf in _leaves_with_path(tree) if not _finite(leaf)]


def check_finite(tree: Any, context: str = "") -> None:
    """Raise with the offending leaf paths if the tree has NaN/Inf."""
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(
            f"non-finite values{' in ' + context if context else ''}: "
            f"{bad[:8]}{'...' if len(bad) > 8 else ''}",
        )

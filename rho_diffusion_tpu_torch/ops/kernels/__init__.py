"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its kernel's plain version for a tensor on the CPU and,
for a CUDA tensor, launches the kernel or raises. ``launch_counts`` counts
the launches per kernel (the wrapper adds one where it launches, nowhere
else), so a run can show that its path went through the kernels; clear it
before the run to be measured.

A kernel's output is written through a raw pointer, so it carries no
autograd history. Each differentiable op is therefore a
``torch.autograd.Function`` whose forward and backward call the launchers,
and every launcher calls ``check_no_autograd`` first: a launch reached under
grad mode with an input that requires grad (a kernel wired in without a
backward) raises instead of silently cutting the graph.
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter

import torch

launch_counts: Counter = Counter()


@functools.cache
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index`` (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(device: torch.device):
    """``torch.cuda.device(device)``, or nothing when it is already current:
    entering it costs two device switches a launch."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_no_autograd(name: str, *tensors) -> None:
    """Raise when ``name``'s raw launch would drop the autograd graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel launch was reached under grad mode with an input that "
            "requires grad; a raw launch has no backward and would cut the autograd "
            "graph. Call it through its torch.autograd.Function",
        )

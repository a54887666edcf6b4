"""Timing for the port's benchmark entries.

``chain_time`` is the counterpart of the JAX scripts' ``timeit`` /
``chain_time``: the step ``x -> step(x)`` (each script's step is
``x + 0.001 * f(x)``, so every call depends on the last) run ``iters``
times between two CUDA events after one warm-up run, best of ``reps``. On
the CPU (``-d cpu``, for tests at shrunk shapes) it reads the host clock
instead: such a number is the CPU's, never the card's. ``device_ms`` is
the device time per call of the port's kernels, from ``torch.profiler``.
The profiler can miss launches (on the H100 one run recorded none of five
launches of a kernel, and about half of ten), so a sum over the launches it
recorded reads low: ``per_call_ms`` takes their mean duration times the
launches one call makes, which the wrappers count themselves.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

PEAK_BF16 = 989e12  # H100 SXM dense bf16 (data sheet)


def parse_device(description: str, argv=None, **extra) -> argparse.Namespace:
    """The common ``-d cuda|cpu`` parser (CUDA by default, raising when it
    is absent); ``extra`` maps further argument names to their kwargs."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"))
    for name, kwargs in extra.items():
        parser.add_argument(name, **kwargs)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass -d cpu for a CPU run")
    args.device = torch.device(args.device)
    return args


def device_line(device: torch.device) -> str:
    """What the numbers were taken on: the card's nvidia-smi name and power
    limit, or the CPU."""
    if device.type != "cuda":
        return "device=cpu (host clock: no device measurement)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return f"device={torch.cuda.get_device_name(device)} nvidia-smi={smi}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain_time(step, x: torch.Tensor, iters: int = 20, reps: int = 3) -> float:
    """Best milliseconds per step of ``iters`` chained steps from x."""
    device = x.device
    with torch.no_grad():
        for _ in range(iters):  # warm-up
            x = step(x)
        _sync(device)
        best = float("inf")
        for _ in range(reps):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    x = step(x)
                end.record()
                torch.cuda.synchronize(device)
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    x = step(x)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms / iters)
    return best


def per_call_ms(by_name: dict, substring: str, launches_per_call: int):
    """(device ms per call, launches recorded) of the CUDA kernels whose
    names hold ``substring``, from ``{kernel name: (device ms, launches
    recorded)}``: the recorded launches' mean duration times the launches
    one call makes; (None, 0) when the profiler recorded none."""
    hits = [(ms, n) for name, (ms, n) in by_name.items() if substring in name]
    recorded = sum(n for _, n in hits)
    if not recorded:
        return None, 0
    return sum(ms for ms, _ in hits) / recorded * launches_per_call, recorded


# spin kernels launched at the head of every profiled window: late in a
# process that has traced a lot, torch.profiler drops a window's first
# device events (on the H100, 8 of 20 after chip_smoke's gauss phase), and
# these take the loss in place of the launches measured
WINDOW_LEAD_LAUNCHES = 1024
LEAD_KERNEL = "spin_kernel"


def trace_events(fn, iters: int) -> list:
    """The raw torch.profiler events (host ops and CUDA activity) of
    ``iters`` calls of ``fn`` (in the caller's grad mode), the window's lead
    of spin kernels left out. Raw: building the profiler's event tree from
    a long trace (a whole sample's 70 k launches and their host ops) takes
    longer than the sample."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WINDOW_LEAD_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.profiler.kineto_results.events() if LEAD_KERNEL not in e.name()]


def device_events(events) -> list:
    """The device's own work among raw profiler events: kernels, copies
    and memsets. A record_function range (the optimizer's step, a scope)
    also has a span on the device's timeline, over kernels already
    counted; it is left out."""
    return [e for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]


def kernel_events(fn, iters: int) -> dict:
    """{CUDA kernel name: (device ms, launches recorded)} over ``iters``
    calls of ``fn`` (in the caller's grad mode)."""
    by_name: dict = {}
    for e in device_events(trace_events(fn, iters)):
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return by_name


def device_ms(fn, names, iters: int = 10):
    """Device milliseconds per call of ``fn`` (work on the card) in the
    kernels counted as ``names`` in ``launch_counts``, each count's name a
    substring of its CUDA kernel's name; None when the profiler recorded
    none of one kernel's launches."""
    from rho_diffusion_tpu_torch.ops.kernels import launch_counts

    before = {n: launch_counts[n] for n in names}
    fn()  # warm-up, and the launches one call makes
    torch.cuda.synchronize()
    per_call = {n: launch_counts[n] - before[n] for n in names}
    by_name = kernel_events(fn, iters)
    total = 0.0
    for n in names:
        ms, _ = per_call_ms(by_name, n, per_call[n])
        if ms is None:
            return None
        total += ms
    return total


def tflops(flops: float, ms: float) -> float:
    return flops / ms / 1e9

"""Device-time op table of the flagship training step (or a sample), on the card.

    python -m rho_diffusion_tpu_torch.benchmarks.op_table

Port of ``benchmarks/xprof_op_table.py``: it warms the workload up (3
steps), traces ``XPROF_STEPS`` (3) more with torch.profiler
(``_timing.trace_events``, whose lead of spin kernels takes the events a
late profiler window drops) and prints one JSON line:

* ``window_ms``: the device time of the traced steps (every kernel, copy
  and memset the profiler recorded, summed; the device-side spans of
  record_function ranges, which cover kernels already counted, left out
  and reported as ``annotations_left_out_ms``), ``per_step_ms``;
* ``groups``: device time and launches by ``GROUPS``, a fixed mapping from
  a kernel's name to one group (the first whose substrings the name holds,
  else "other"); the groups sum to ``window_ms``;
* ``top_kernels``: the kernels with the most device time;
* ``top_ops``: the operators (aten ops, the port's autograd Functions)
  with the most self device time, each kernel counted under the innermost
  operator that launched it: these split the elementwise and reduction
  kernels into the GroupNorm statistics, SiLU, casts, adds, ...;
* ``scopes``: the device time of the kernels that ``GroupNorm32`` launches,
  forward and backward (its forward is traced inside a ``record_function``
  range; a backward node counts when its forward op ran in such a range,
  matched by autograd's sequence number), split by group.

Knobs (JAX's names): ``XPROF_MODE`` train (default: the DDPM flagship's
training step, UNetv2 32^3, model_channels 64, channel_mult (1, 2, 4, 8),
bf16, AdamW lr 1e-4, EMA 0.9999, a fixed random batch) or sample (a DDIM
sample of ``XPROF_STEPS`` respaced steps), ``XPROF_GRID`` (32),
``XPROF_BATCH`` (32 for train, 8 for sample), ``XPROF_STEPS`` (3).

It needs CUDA and raises without it, as the JAX script needs a TPU plane;
``op_table`` itself takes any profile's raw events, and on one without
device events (a CPU profile) it tables the operators' self host time
under ``clock`` "host".
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks._timing import device_events

# (group, substrings of the kernel name): the first group whose substrings
# the name holds. The port's kernels first (the flash pre-passes' names hold
# "tf32_split"), then the library convs (cuDNN's wgrad before its other
# convs, whose names may hold "implicit_gemm" too), cuBLAS, and PyTorch's
# own kernels: casts and copies before the elementwise group, whose
# templates wrap the copy functors too.
GROUPS = (
    ("flash forward (K1/K2; K6 ring)", ("flash_fwd", "ring_attention", "kv_split")),
    ("flash backward and its pre-passes (K3/K4)", ("flash_bwd",)),
    ("K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
     ("conv3d_igemm", "conv3d_tf32", "tf32_split_kernel", "conv3d_variant", "conv3d_bigdot",
      "conv3d_dotsonly")),
    ("direct conv (input conv, head, head dgrad)", ("conv3d_direct",)),
    ("cuDNN weight gradients", ("wgrad",)),
    ("other cuDNN convs (the strided Downsample)",
     ("fprop", "dgrad", "implicit_gemm", "implicit_convolve", "conv2d", "conv3d", "cudnn")),
    ("GroupNorm (PyTorch's own kernels)",
     ("group_norm", "GroupNorm", "RowwiseMoments", "ComputeFusedParams")),
    ("optimizer and EMA (foreach, multi-tensor)", ("multi_tensor_apply", "foreach", "_foreach")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "cublas", "nvjet", "splitKreduce", "addmm", "aten::mm",
                      "aten::bmm")),
    ("casts and copies", ("copy", "Copy", "Memcpy", "_to_", "aten::cat")),
    ("reductions", ("reduce_kernel", "reduce", "Reduce", "mean", "sum", "norm")),
    ("SiLU and other elementwise", ("silu", "elementwise", "mul", "add", "sub", "div", "where",
                                    "sqrt", "pow", "clamp", "neg", "exp", "fill")),
)
OTHER = "other"
SCOPE = "GroupNorm32"
SCOPE_NAME = "GroupNorm32 (forward and backward)"
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "
TOP = 25


def group_of(name: str) -> str:
    """The group of a kernel (or, on a CPU profile, an operator) name."""
    return next((g for g, keys in GROUPS if any(k in name for k in keys)), OTHER)


def _frontend(events) -> list:
    """The operator and range events (not the CUDA runtime's), each with
    its parent by nesting on its thread."""
    ops = sorted((e for e in events if e.device_type() == torch.autograd.DeviceType.CPU
                  and e.linked_correlation_id() == 0),
                 key=lambda e: (e.start_thread_id(), e.start_ns(), -e.duration_ns()))
    parents: list = []
    stack: list = []
    for i, e in enumerate(ops):
        while stack and (ops[stack[-1]].start_thread_id() != e.start_thread_id()
                         or ops[stack[-1]].end_ns() <= e.start_ns()):
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return list(zip(ops, parents))


def _scoped(frontend) -> list[bool]:
    """Per frontend event: whether SCOPE launched it, in its forward range
    or in the backward node of an op run in that range."""
    inside, node = [], []
    for e, parent in frontend:
        inside.append(e.name() == SCOPE or (parent is not None and inside[parent]))
        node.append(e if e.name().startswith(BACKWARD_PREFIX)
                    else node[parent] if parent is not None else None)
    forward = {(e.start_thread_id(), e.sequence_nr())
               for (e, _), ins in zip(frontend, inside) if ins and e.sequence_nr() >= 0}
    return [ins or (n is not None and (n.fwd_thread_id(), n.sequence_nr()) in forward)
            for ins, n in zip(inside, node)]


def _add(table: dict, key: str, ms: float) -> None:
    ms0, n0 = table.get(key, (0.0, 0))
    table[key] = (ms0 + ms, n0 + 1)


def _rows(table: dict, total: float, top: Optional[int] = None) -> list:
    rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"name": k, "ms": ms, "launches": n, "share": ms / total if total else None}
            for k, (ms, n) in rows]


def op_table(events: Iterable, top: int = TOP) -> dict:
    """The table of one profile's raw events (``trace_events`` or
    ``prof.profiler.kineto_results.events()``)."""
    events = list(events)
    frontend = _frontend(events)
    scoped = _scoped(frontend)
    device = device_events(events)
    annotations_ms = sum(e.duration_ns() for e in events
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and e.is_user_annotation()) / 1e6
    groups: dict = {}
    kernels: dict = {}
    ops: dict = {}
    scope: dict = {}
    if device:
        index = {e.correlation_id(): i for i, (e, _) in enumerate(frontend)}
        items = []
        for k in device:
            i = index.get(k.linked_correlation_id())
            items.append((k.name(), k.duration_ns() / 1e6,
                          frontend[i][0].name() if i is not None else "(no operator)",
                          i is not None and scoped[i]))
    else:  # a CPU profile: each operator's self time on the host clock
        child_ns = [0] * len(frontend)
        for e, parent in frontend:
            if parent is not None:
                child_ns[parent] += e.duration_ns()
        items = [(e.name(), (e.duration_ns() - c) / 1e6, e.name(), s)
                 for (e, _), c, s in zip(frontend, child_ns, scoped)]
    for name, ms, op, in_scope in items:
        _add(groups, group_of(name), ms)
        _add(kernels, name, ms)
        _add(ops, op, ms)
        if in_scope:
            _add(scope, group_of(name), ms)
    total = sum(ms for ms, _ in groups.values())
    scope_ms = sum(ms for ms, _ in scope.values())
    return {
        "clock": "device" if device else "host",
        "window_ms": total,
        "launches": sum(n for _, n in groups.values()),
        "annotations_left_out_ms": annotations_ms,
        "groups": _rows(groups, total),
        "top_kernels": _rows(kernels, total, top),
        "top_ops": _rows(ops, total, top),
        "scopes": {SCOPE_NAME: {"ms": scope_ms, "launches": sum(n for _, n in scope.values()),
                                "share": scope_ms / total if total else None,
                                "by_group": _rows(scope, scope_ms)}},
    }


@contextlib.contextmanager
def traced_scope():
    """GroupNorm32's forward inside a record_function range named SCOPE,
    for the length of the block."""
    from rho_diffusion_tpu_torch.ops.norm import GroupNorm32

    forward = GroupNorm32.forward

    def scoped_forward(self, x):
        with torch.profiler.record_function(SCOPE):
            return forward(self, x)

    GroupNorm32.forward = scoped_forward
    try:
        yield
    finally:
        GroupNorm32.forward = forward


def settings() -> dict:
    mode = os.environ.get("XPROF_MODE", "train")
    if mode not in ("train", "sample"):
        raise ValueError(f"XPROF_MODE={mode!r}; expected train or sample")
    return {"mode": mode, "grid": int(os.environ.get("XPROF_GRID", 32)),
            "batch": int(os.environ.get("XPROF_BATCH", 32 if mode == "train" else 8)),
            "steps": int(os.environ.get("XPROF_STEPS", 3)), "mc": 64}


def backbone_kwargs(s: dict) -> dict:
    return dict(data_shape=(s["grid"],) * 3, dims=3, in_channels=1, out_channels=1,
                model_channels=s["mc"], num_res_blocks=2, channel_mult=(1, 2, 4, 8),
                attention_resolutions=[16, 8], num_heads=4, num_classes=20,
                use_scale_shift_norm=True, dtype="bfloat16")


def workload(s: dict, device):
    """A function running one step of the workload (train) or one sample of
    ``steps`` steps, and the steps a call makes."""
    from rho_diffusion_tpu_torch.diffusion import DDPM, GaussianDiffusionPipeline, LinearSchedule

    rng = np.random.default_rng(0)
    conds = torch.from_numpy(
        rng.uniform(0, 1, (s["batch"], 4 * s["mc"])).astype(np.float32)).to(device)
    if s["mode"] == "train":
        pipe = DDPM(backbone="UNetv2", backbone_kwargs=backbone_kwargs(s),
                    schedule=LinearSchedule(1000), optimizer="AdamW", opt_kwargs={"lr": 1e-4},
                    ema_decay=0.9999, device=device, seed=0)
        state = pipe.create_state(0)
        data = torch.from_numpy(rng.uniform(0, 1, (s["batch"], *(s["grid"],) * 3, 1))
                                .astype(np.float32)).to(device)
        batch = {"data": data, "labels": conds}
        return (lambda: pipe.training_step(state, batch)), 1
    pipe = GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=backbone_kwargs(s), schedule=LinearSchedule(1000),
        model_mean_type="epsilon", model_var_type="fixed_large", optimizer="AdamW",
        device=device, seed=0)
    shape = pipe.sample_shape(s["batch"])

    def sample():
        pipe.reverse_process(shape, conds, sampler="ddim", num_steps=s["steps"],
                             generator=torch.Generator(device=device).manual_seed(0))

    return sample, s["steps"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse

    from rho_diffusion_tpu_torch.benchmarks._timing import device_line, trace_events

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the op table traces the card's kernels: CUDA is not available")
    device = torch.device("cuda")
    s = settings()
    step, steps_per_call = workload(s, device)
    for _ in range(3):  # warm-up
        step()
    torch.cuda.synchronize()
    calls = 1 if s["mode"] == "sample" else s["steps"]
    with traced_scope():
        events = trace_events(step, calls)
    table = op_table(events)
    steps = calls * steps_per_call
    result = {"workload": f"{s['mode']} {s['grid']}^3 batch {s['batch']} (bf16, mc={s['mc']})",
              "device": device_line(device), "steps": steps, **table,
              "per_step_ms": table["window_ms"] / steps}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

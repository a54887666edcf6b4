"""Per-row noise streams for the samplers.

Port of ``rho_diffusion_tpu/diffusion/sampling_rng.py:1-65``. A serving
system micro-batches concurrent requests, so a request's result must not
depend on its co-batched neighbours. In per-row mode every sample row draws
its noise from its own stream: row i of a request seeded s has the 64-bit
key ``row_key(s, i)``, its initial x_T is drawn at step tag T and the noise
of step t at tag t, each from a ``torch.Generator`` seeded with
``step_key(row key, tag)``. A row's noise is therefore a pure function of
(seed, row, step), whatever the batch composition, padding or split.

The keys are a fixed splitmix64 mix of the integers, and the bits are
torch's (Philox on the card, Mersenne Twister on the CPU), not JAX's: the
contract is the same, the numbers are not.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rho_diffusion_tpu_torch.parallel import spmd

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _mix(a: int, b: int) -> int:
    return _splitmix64(_splitmix64(a & _MASK) ^ (b & _MASK))


def row_key(seed: int, row: int) -> int:
    """The key of row ``row`` of a request seeded ``seed`` (the seed is
    taken mod 2^32, as in JAX)."""
    return _mix(int(seed) & 0xFFFFFFFF, int(row))


def per_sample_keys(seed: int, n: int, start: int = 0) -> list[int]:
    """Keys of rows [start, start + n) of a request seeded ``seed``:
    splitting a request across launches never changes a row's stream."""
    return [row_key(seed, i) for i in range(start, start + n)]


def keys_from_seeds(seeds: Sequence[int], idxs: Sequence[int]) -> list[int]:
    """Row keys from parallel (seed, row index) integer sequences, as the
    service ships them per launch."""
    return [row_key(s, i) for s, i in zip(seeds, idxs)]


def keys_at_step(keys: Sequence[int], t: int) -> list[int]:
    """Each row's key for step tag ``t``."""
    return [_mix(k, int(t)) for k in keys]


def normal_like(keys: Sequence[int], shape, device, dtype=torch.float32) -> torch.Tensor:
    """Gaussian noise of ``shape`` with row i drawn from a generator seeded
    with ``keys[i]`` (len(keys) == shape[0]). Inside a rank that holds a
    depth slab of the volume (``parallel.spmd``), ``shape`` is the slab's,
    and the noise is that slab of each row's whole volume of noise."""
    rank = spmd.spatial_rank()
    if rank is not None and len(shape) > 2:
        n, depth = rank.group.n, shape[1]
        whole = _normal_like(keys, (shape[0], depth * n, *shape[2:]), device, dtype)
        return whole[:, rank.context * depth:(rank.context + 1) * depth].contiguous()
    return _normal_like(keys, shape, device, dtype)


def _normal_like(keys: Sequence[int], shape, device, dtype=torch.float32) -> torch.Tensor:
    if len(keys) != shape[0]:
        raise ValueError(f"{len(keys)} row keys for a batch of {shape[0]}")
    out = torch.empty(shape, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    for i, key in enumerate(keys):
        gen.manual_seed(key)
        out[i].normal_(generator=gen)
    return out

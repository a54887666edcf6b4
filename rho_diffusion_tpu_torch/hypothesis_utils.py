"""Property-based-testing strategies that draw torch tensors.

Port of ``rho_diffusion_tpu/hypothesis_utils.py`` (the reference's
torch-tensor strategies, adapted from torch-hypothesis): composite
strategies drawing random shapes, dtypes and value ranges. ``hypothesis``
is imported where it is installed; without it the strategy raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

try:
    from hypothesis import strategies as st

    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAS_HYPOTHESIS = False


def from_range_value_or_choice(draw, spec, default_strategy):
    """Resolve a flexible spec: a 2-tuple is a range, a list or set a
    choice, a scalar is fixed, None draws from ``default_strategy``."""
    if spec is None:
        return draw(default_strategy)
    if isinstance(spec, tuple) and len(spec) == 2:
        lo, hi = spec
        if isinstance(lo, int) and isinstance(hi, int):
            return draw(st.integers(lo, hi))
        return draw(st.floats(float(lo), float(hi), allow_nan=False))
    if isinstance(spec, (list, set)):
        return draw(st.sampled_from(sorted(spec, key=str)))
    return spec


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


if HAS_HYPOTHESIS:

    @st.composite
    def torch_tensors(
        draw,
        shape: Optional[Union[tuple, Sequence]] = None,
        dtype=None,
        min_value: float = -10.0,
        max_value: float = 10.0,
        min_dims: int = 1,
        max_dims: int = 4,
        max_side: int = 8,
    ):
        """A random tensor: its shape (``min_dims`` to ``max_dims`` sides of
        1 to ``max_side``) unless given, its dtype (numpy or torch; float32
        or int32 unless given, a range-or-choice spec as above) and values
        uniform in [min_value, max_value] (integers inclusive), from a
        numpy generator seeded by the draw."""
        if shape is None:
            ndims = draw(st.integers(min_dims, max_dims))
            shape = tuple(draw(st.integers(1, max_side)) for _ in range(ndims))
        elif not isinstance(shape, tuple):
            shape = tuple(shape)
        dtype = from_range_value_or_choice(draw, dtype, st.sampled_from([np.float32, np.int32]))
        seed = draw(st.integers(0, 2**31 - 1))
        rng = np.random.default_rng(seed)
        if _is_integer(dtype):
            arr = rng.integers(int(min_value), int(max_value) + 1, size=shape)
        else:
            arr = rng.uniform(min_value, max_value, size=shape)
        if isinstance(dtype, torch.dtype):
            return torch.from_numpy(arr).to(dtype)
        return torch.from_numpy(arr.astype(dtype))
else:  # pragma: no cover
    def torch_tensors(*args, **kwargs):
        raise ImportError("hypothesis is required for torch_tensors")

"""Dataset base abstractions (the port's copy of
``rho_diffusion_tpu/data/base.py``): datasets are host-side, channels-LAST
([*spatial, C]) numpy producers; device placement happens in the pipeline,
never inside a dataset.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np


class AbstractDataset:
    """Map-style dataset: __len__ + __getitem__ -> (data, label)."""

    parameter_space: Any = None
    attributes: dict = {}

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError


class MultiVariateDataset(AbstractDataset):
    """Marker for datasets conditioned on a multi-dimensional parameter
    space (reference base.py:27-32)."""


class UnivariateDataset(AbstractDataset):
    """Marker for single-parameter datasets (reference base.py:35-38)."""


class Density(np.ndarray):
    """A density field (numpy) with an optional coordinate grid.

    ``normalize()`` rescales so the field integrates to one over the grid.
    """

    def __new__(cls, data, coords: Optional[np.ndarray] = None):
        obj = np.asarray(data).view(cls)
        obj.coords = coords
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.coords = getattr(obj, "coords", None)

    def normalize(self) -> "Density":
        """The field divided by the sum of its absolute values (itself when
        that sum is zero)."""
        total = float(np.sum(np.abs(self)))
        if total == 0.0:
            return self
        return Density(np.asarray(self) / total, coords=self.coords)

    def marginalize(self, axis: int | tuple) -> "Density":
        """The marginal density over ``axis``."""
        return Density(np.sum(np.asarray(self), axis=axis))

    def sample(self, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
        """``n`` grid indices drawn with probability proportional to |field|,
        as [n, ndim] index rows."""
        rng = rng or np.random.default_rng()
        p = np.abs(np.asarray(self, dtype=np.float64)).ravel()
        total = p.sum()
        if total <= 0:
            raise ValueError("cannot sample from an all-zero density")
        flat = rng.choice(p.size, size=n, p=p / total)
        return np.stack(np.unravel_index(flat, self.shape), axis=1)

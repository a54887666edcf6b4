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


class Density(np.ndarray):
    """A density field (numpy) with an optional coordinate grid."""

    def __new__(cls, data, coords: Optional[np.ndarray] = None):
        obj = np.asarray(data).view(cls)
        obj.coords = coords
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.coords = getattr(obj, "coords", None)

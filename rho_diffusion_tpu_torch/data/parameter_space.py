"""Discrete physics-parameter spaces (the port's copy of
``rho_diffusion_tpu/data/parameter_space.py``): a dict-like container mapping
parameter names to their admissible value lists, with Cartesian-product
sampling (random rows, or sequential first-N rows for eval grids)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Optional, Sequence

import numpy as np

from rho_diffusion_tpu_torch.utils import (
    discrete_parameter_combinations,
    sample_from_discrete_parameter_space,
)


class AbstractParameterSpace:
    """Dict-like base."""

    def __init__(self) -> None:
        self.parameters: "OrderedDict[str, Sequence]" = OrderedDict()

    def __getitem__(self, key: str) -> Sequence:
        return self.parameters[key]

    def __setitem__(self, key: str, value: Sequence) -> None:
        self.parameters[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.parameters

    def __iter__(self) -> Iterator[str]:
        return iter(self.parameters)

    def __len__(self) -> int:
        return len(self.parameters)

    def keys(self):
        return self.parameters.keys()

    def values(self):
        return self.parameters.values()

    def items(self):
        return self.parameters.items()


class DiscreteParameterSpace(AbstractParameterSpace):
    """A finite Cartesian-product parameter space."""

    def __init__(
        self,
        param_dict: Optional[dict] = None,
        sampler: Optional[np.random.Generator] = None,
    ) -> None:
        super().__init__()
        if param_dict:
            for k, v in param_dict.items():
                self.parameters[k] = list(v)
        self.sampler = sampler or np.random.default_rng()

    def push_parameter(self, name: str, values: Sequence) -> None:
        self.parameters[name] = list(values)

    def size(self) -> int:
        """Total number of combinations |product of value lists|."""
        n = 1
        for v in self.parameters.values():
            n *= len(v)
        return n

    def combinations(self) -> np.ndarray:
        return discrete_parameter_combinations(self.parameters)

    def sample(self, batch_size: int, random: bool = True) -> np.ndarray:
        return sample_from_discrete_parameter_space(
            self.parameters, batch_size, random=random, rng=self.sampler,
        )

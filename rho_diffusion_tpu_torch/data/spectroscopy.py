"""1D rotational-spectroscopy dataset, the Conv1d diffusion testbed.

Port of ``rho_diffusion_tpu/data/spectroscopy.py`` (reference
spectroscopy.py:35-189): HDF5 groups (one per molecule) store stick spectra
(``transitions`` = [centers; log10 intensities]) and a ``params`` row; each
__getitem__ simulates a Gaussian-lineshape spectrum onto a fixed frequency
grid with a linewidth ~ |N(1, 0.1)| drawn from the dataset's own locked
generator (or a fixed width), normalised to unit peak. Items are dicts:
``spectrum`` [grid_size, 1] (channels-last), ``params``, ``max_int``.
h5py is imported only when a file is read.
"""
from __future__ import annotations

import threading
from functools import cached_property
from pathlib import Path
from typing import Optional, Union

import numpy as np

from rho_diffusion_tpu_torch.data.base import UnivariateDataset
from rho_diffusion_tpu_torch.registry import registry


@registry.register_dataset("SpectroscopyDataset")
class SpectroscopyDataset(UnivariateDataset):
    def __init__(
        self,
        h5_path: Union[str, Path],
        min_freq: Optional[float] = None,
        max_freq: Optional[float] = None,
        grid_size: int = 50_000,
        linewidth: Optional[Union[float, tuple]] = None,
        seed: int = 0,
        indices: Optional[list] = None,
    ) -> None:
        self.h5_path = Path(h5_path)
        if not self.h5_path.exists():
            raise FileNotFoundError(f"Target HDF5 not found: {h5_path}")
        self.min_freq = min_freq or 1000.0
        self.max_freq = max_freq or 32000.0
        self.grid_size = grid_size
        self._linewidth = linewidth
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        # molecule-subset view: train/holdout splits over the h5 groups
        # without rewriting the corpus
        self.indices = list(indices) if indices is not None else None

    def sample_linewidth(self) -> float:
        """Fixed width, or |N(mu, sigma)| per sample
        (reference spectroscopy.py:61-77, 117-118)."""
        lw = self._linewidth
        if isinstance(lw, float):
            return lw
        mu, sigma = lw if isinstance(lw, tuple) else (1.0, 0.1)
        # worker threads call __getitem__ and numpy Generators are not
        # thread-safe
        with self._rng_lock:
            return float(abs(self._rng.normal(mu, sigma)))

    @cached_property
    def frequency_grid(self) -> np.ndarray:
        return np.linspace(
            self.min_freq, self.max_freq, self.grid_size, dtype=np.float32,
        )

    def __len__(self) -> int:
        import h5py

        if self.indices is not None:
            return len(self.indices)
        with h5py.File(self.h5_path, "r") as f:
            return len(f)

    @cached_property
    def parameter_space(self):
        """Physics-parameter space rebuilt from the whole corpus's ``params``
        rows (B, T, D, n_lines), for a conditional model (cond_fn over raw
        parameter rows; ``default_collate`` maps 'params' to labels)."""
        import h5py

        from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace

        with h5py.File(self.h5_path, "r") as f:
            rows = np.stack([np.asarray(g["params"]) for g in f.values()])
        names = ["B", "T", "D", "n_lines"][: rows.shape[1]]
        return DiscreteParameterSpace(
            param_dict={
                k: sorted(np.unique(rows[:, i]).tolist())
                for i, k in enumerate(names)
            },
        )

    def __getitem__(self, index: int) -> dict:
        import h5py

        if self.indices is not None:
            index = self.indices[index]
        with h5py.File(self.h5_path, "r") as f:
            group = f[str(index)]
            data = {k: np.asarray(v, dtype=np.float32) for k, v in group.items()}
        centers, intensities = data.pop("transitions")
        # intensities stored as log10; clip underflow (reference :121-123)
        intensities = np.clip(intensities, -10.0, -2.0)
        profile = self.simulate_lineprofile(
            self.frequency_grid, centers, 10.0**intensities, self.sample_linewidth(),
        )
        data["max_int"] = np.asarray([10.0 ** intensities.max()], np.float32)
        peak = profile.max()
        if peak > 0:
            profile = profile / peak
        data["spectrum"] = profile.astype(np.float32)[:, None]  # [F, 1]
        return data

    @staticmethod
    def simulate_lineprofile(
        frequency_grid: np.ndarray,
        centers: np.ndarray,
        intensities: np.ndarray,
        width: Union[float, np.ndarray],
    ) -> np.ndarray:
        """Sum of Gaussian lineshapes on the grid
        (reference simulate_lineprofile :142-189)."""
        width = np.atleast_1d(np.asarray(width, dtype=np.float32))
        lo, hi = frequency_grid.min(), frequency_grid.max()
        mask = (centers >= lo) & (centers <= hi)
        if not mask.any():
            return np.zeros_like(frequency_grid)
        comps = intensities[mask, None] * np.exp(
            -((frequency_grid[None, :] - centers[mask, None]) ** 2)
            / (2.0 * width[:, None] ** 2),
        )
        return comps.sum(axis=0)

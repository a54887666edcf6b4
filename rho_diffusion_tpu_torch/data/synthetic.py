"""Synthetic spherical-harmonics density dataset.

Port of ``rho_diffusion_tpu/data/synthetic.py`` with its numpy/scipy field
path:

* grid: meshgrid(indexing="xy") over linspace(-2, 2, grid_el) per axis;
* spherical mapping: theta = arctan(sqrt(x^2+y^2)/z), phi = arctan(y/x);
* field = |sph_harm(|m|, l, theta, phi) * r|, min-max normalised;
* random (l, m) per sample: l ~ [0, max_l), m ~ [-l, l], numpy-seeded;
* labels: sha512 hash embedding of {'l': l, 'm': m} with length 256.

Fields are channels-last [grid_el, grid_el, grid_el, 1]. Not ported yet,
and raising: the C++ generator (``use_native=True``) and HDF5-backed
datasets (``h5_path``).
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from rho_diffusion_tpu_torch.data.base import Density, MultiVariateDataset
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.utils import calculate_sha512_embedding


def _legacy_sph_harm(m: int, l: int, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:  # noqa: E741
    """scipy.special.sph_harm(m, n, theta, phi) (theta azimuthal, phi polar);
    newer scipy only has sph_harm_y(n, m, polar, azimuthal)."""
    try:
        from scipy.special import sph_harm  # scipy < 1.17

        return sph_harm(m, l, theta, phi)
    except ImportError:
        from scipy.special import sph_harm_y

        return sph_harm_y(l, m, phi, theta)


def make_spherical_grid(
    x: np.ndarray, y: np.ndarray, z: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cartesian meshgrid -> (xyz stack, theta, phi)."""
    xg, yg, zg = np.meshgrid(x, y, z, indexing="xy")
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arctan(np.sqrt(xg**2 + yg**2) / zg)
        phi = np.arctan(yg / xg)
    return np.array([xg, yg, zg]), theta, phi


def compute_spherical_harmonic(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    m: int,
    l: int,  # noqa: E741
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """|Y_lm| * r density on a cartesian grid, min-max normalised on the
    complex field (the JAX package's order of operations)."""
    xyz, theta, phi = make_spherical_grid(x, y, z)
    xg, yg, zg = xyz
    radial = np.sqrt(xg**2 + yg**2 + zg**2)
    solution = _legacy_sph_harm(abs(m), l, theta, phi) * radial
    if normalize:
        solution = (solution - solution.min()) / (solution.max() - solution.min())
    return xyz, np.abs(solution), np.real(solution)


@registry.register_dataset("SphericalHarmonicDataset")
class SphericalHarmonicDataset(MultiVariateDataset):
    """On-the-fly spherical-harmonics density dataset."""

    def __init__(
        self,
        max_l: int,
        h5_path: Optional[str | Path] = None,
        length: int = 1000,
        random_seed: Optional[int] = None,
        use_emb_as_labels: bool = True,
        use_native: bool = False,
        cache_fields: bool = True,
        exclude_pairs: Optional[Sequence] = None,
        **grid_kwargs,
    ) -> None:
        assert max_l and max_l > 0, f"invalid max_l: {max_l}"
        if use_native:
            raise NotImplementedError(
                "use_native=True needs the C++ Ylm generator, which the port "
                "does not carry yet; use the numpy/scipy path (use_native=False)",
            )
        if h5_path:
            raise NotImplementedError("HDF5-backed datasets (h5_path) are not ported yet")
        self.max_l = max_l
        self.parameter_space = DiscreteParameterSpace(
            param_dict={
                "l": list(range(0, max_l)),
                "m": list(range(-max_l, max_l)),
            },
        )
        grid_kwargs.setdefault("grid_el", 32)
        for key in ("x", "y", "z"):
            grid_kwargs.setdefault(key, np.linspace(-2.0, 2.0, grid_kwargs["grid_el"]))
        self.grid_kwargs = grid_kwargs
        self.length = length
        self.use_emb_as_labels = use_emb_as_labels
        if random_seed is None:
            random_seed = int(os.getenv("RHO_GLOBAL_SEED", os.getenv("PL_GLOBAL_SEED", 1616)))
        self.random_seed = random_seed
        self._rng = np.random.default_rng(random_seed)
        self._rng_lock = threading.Lock()
        self.cache_fields = cache_fields
        self._field_cache: dict[tuple[int, int], np.ndarray] = {}
        self._label_cache: dict[tuple[int, int], np.ndarray] = {}
        self._exclude = {(int(l), int(m)) for l, m in (exclude_pairs or ())}  # noqa: E741

    def random_set(self) -> tuple[int, int]:
        """Random (l, m) with |m| <= l and l in [0, max_l)."""
        with self._rng_lock:
            while True:
                l = int(self._rng.integers(0, self.max_l))  # noqa: E741
                m = int(self._rng.integers(-l, l + 1))
                if (l, m) not in self._exclude:
                    return l, m

    def __len__(self) -> int:
        return self.length

    def _label(self, l: int, m: int) -> np.ndarray:  # noqa: E741
        if not self.use_emb_as_labels:
            return np.asarray([l, m], dtype=np.float32)
        cached = self._label_cache.get((l, m))
        if cached is not None:
            return cached
        emb = calculate_sha512_embedding({"l": int(l), "m": int(m)}, l=256)
        self._label_cache[(l, m)] = emb
        return emb

    def __getitem__(self, index: int):
        l, m = self.random_set()  # noqa: E741
        density = self._field_cache.get((l, m)) if self.cache_fields else None
        if density is None:
            grid = {k: self.grid_kwargs[k] for k in ("x", "y", "z")}
            _, density, _ = compute_spherical_harmonic(**grid, m=m, l=l)
            if self.cache_fields:
                self._field_cache[(l, m)] = density
        field = Density(density.astype(np.float32)[..., None])  # channels-last
        return field, self._label(l, m)

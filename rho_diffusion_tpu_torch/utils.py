"""Framework-wide utilities of the PyTorch port.

The port's own copies of the pieces of ``rho_diffusion_tpu/utils.py`` that
the sampling path uses (the JAX package's ``__init__`` imports flax, so the
port never imports it):

* ``calculate_sha512_embedding`` — the hash-conditioning trick: sha512 of the
  sorted-key JSON of a parameter dict, hexdigest chars -> ASCII codes / 128;
* ``parameter_space_to_embeddings`` — stacked hash embeddings of every row of
  a Cartesian parameter product;
* ``sample_from_discrete_parameter_space`` — random or first-N rows;
* ``number_cast_dict`` — numeric-string coercion for JSON configs;

plus ``resolve_device``, the port's one rule for where entry points run, and
the matplotlib plot helper, imported only when a plot is written.
"""
from __future__ import annotations

import hashlib
import itertools
import json
from typing import Any, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Device policy
# ---------------------------------------------------------------------------

def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """Where an entry point runs: CUDA unless the caller asks for the CPU.

    ``None``, ``"tpu"`` (the JAX configs' device string), ``"gpu"`` and
    ``"cuda[:N]"`` all mean the card. With no CUDA device this raises rather
    than carrying on quietly on the CPU; pass ``"cpu"`` explicitly to run
    there (the tests do).
    """
    name = "cuda" if device is None else str(device)
    if name in ("tpu", "gpu"):
        name = "cuda"
    if name == "cpu":
        return torch.device("cpu")
    if not name.startswith("cuda"):
        raise ValueError(f"unknown device '{device}'; expected cuda, gpu, tpu or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' needs CUDA, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU",
        )
    return torch.device(name)


# ---------------------------------------------------------------------------
# Hash-based conditioning embeddings
# ---------------------------------------------------------------------------

def calculate_sha512_embedding(d: dict, l: int = 128) -> np.ndarray:  # noqa: E741
    """Deterministically embed a parameter dict as a float vector: each of
    the 128 sha512 hexdigest chars' ASCII code, repeated ``l // 128`` times
    and divided by 128 (bit-exact with the JAX package)."""
    h = hashlib.sha512(json.dumps(d, sort_keys=True).encode()).hexdigest()
    codes = np.frombuffer(h.encode("ascii"), dtype=np.uint8)
    return (np.repeat(codes, max(l // 128, 1)) / 128.0).astype(np.float32)


def parameter_space_to_embeddings(param_dict: dict, l: int = 128) -> np.ndarray:  # noqa: E741
    """Hash-embed every combination of a discrete parameter space. Rows
    follow ``itertools.product`` order."""
    keys, values = zip(*param_dict.items())
    combos = [dict(zip(keys, v)) for v in itertools.product(*values)]
    return np.stack([calculate_sha512_embedding(c, l=l) for c in combos])


def discrete_parameter_combinations(param_dict: dict) -> np.ndarray:
    """All rows of the Cartesian product of a parameter-space dict, as a
    float32 array of shape [prod(len(v_i)), n_params]."""
    values = list(param_dict.values())
    return np.asarray(list(itertools.product(*values)), dtype=np.float32)


def sample_from_discrete_parameter_space(
    param_dict: dict,
    batch_size: int,
    random: bool = True,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Draw ``batch_size`` parameter rows: uniformly at random, or the first
    N rows sequentially (cycled) for deterministic eval grids."""
    combos = discrete_parameter_combinations(param_dict)
    n = combos.shape[0]
    if random:
        rng = rng or np.random.default_rng()
        idx = rng.integers(0, n, size=batch_size)
    else:
        idx = np.arange(batch_size) % n
    return combos[idx]


# ---------------------------------------------------------------------------
# Config coercion helpers
# ---------------------------------------------------------------------------

def _maybe_number(v: Any) -> Any:
    if isinstance(v, str):
        try:
            f = float(v)
        except ValueError:
            return v
        if f.is_integer() and ("." not in v and "e" not in v.lower()):
            return int(f)
        return f
    return v


def number_cast_dict(d: dict) -> dict:
    """Recursively cast numeric strings ("1e-4", "32") in a (nested) dict to
    numbers, preserving everything else."""
    out: dict = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = number_cast_dict(v)
        elif isinstance(v, (list, tuple)):
            out[k] = type(v)(
                number_cast_dict(x) if isinstance(x, dict) else _maybe_number(x)
                for x in v
            )
        else:
            out[k] = _maybe_number(v)
    return out


# ---------------------------------------------------------------------------
# Plotting (host-side; matplotlib is imported only here)
# ---------------------------------------------------------------------------

def plot_tensor_images(data: np.ndarray, filename: str | None = None,
                       threshold: float = 0.5):
    """Plot a batch of channels-last fields [N, *spatial, C]: 2-D as an
    image grid, 3-D as thresholded voxel scatters."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray(data)
    if data.shape[-1] == 1:
        data = data[..., 0]
    n = data.shape[0]
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig = plt.figure(figsize=(ncols * 3, nrows * 3))
    for i in range(n):
        if data.ndim - 1 <= 2:
            ax = fig.add_subplot(nrows, ncols, i + 1)
            ax.imshow(np.atleast_2d(data[i]), cmap="viridis")
        else:
            ax = fig.add_subplot(nrows, ncols, i + 1, projection="3d")
            vol = data[i]
            mask = vol > threshold * vol.max() if vol.max() > 0 else vol > threshold
            xs, ys, zs = np.nonzero(mask)
            ax.scatter(xs, ys, zs, c=vol[mask], s=2, cmap="viridis", alpha=0.4)
        ax.set_axis_off()
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
    return fig

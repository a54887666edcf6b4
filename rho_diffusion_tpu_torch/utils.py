"""Framework-wide utilities of the PyTorch port.

The port's own copies of the pieces of ``rho_diffusion_tpu/utils.py`` that
the sampling path uses (the JAX package's ``__init__`` imports flax, so the
port never imports it):

* ``calculate_sha512_embedding`` — the hash-conditioning trick: sha512 of the
  sorted-key JSON of a parameter dict, hexdigest chars -> ASCII codes / 128;
* ``vector_to_embeddings`` / ``parameter_space_to_embeddings`` — stacked
  hash embeddings of the scalars of a vector, or of every row of a
  Cartesian parameter product;
* ``sample_from_discrete_parameter_space`` — random or first-N rows;
* ``number_cast_dict`` — numeric-string coercion for JSON configs;
* ``right_pad_dims_to`` — trailing singleton dims, on numpy arrays and torch
  tensors;

plus ``resolve_device``, the port's one rule for where entry points run, and
the matplotlib plot helpers (``plot_image_grid``, ``plot_tensor_images``),
which import matplotlib only when a plot is written.

``enable_persistent_compile_cache`` points XLA's compilation cache at a
directory; the port compiles no XLA programs (its kernels are built by
``ops/kernels/_build.py``, cached by source hash), so it has no counterpart.
"""
from __future__ import annotations

import hashlib
import itertools
import json
from typing import Any, Optional, Sequence

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


def vector_to_embeddings(v: Sequence, keyname: str, l: int = 128) -> np.ndarray:  # noqa: E741
    """Hash-embed each scalar of ``v`` as ``{keyname: int(v_i)}``: one
    row per element, stacked."""
    return np.stack([calculate_sha512_embedding({keyname: int(x)}, l=l) for x in v])


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


def right_pad_dims_to(x, target_ndim: int):
    """Append trailing singleton dims until ``x.ndim == target_ndim``; a
    numpy array stays one, a tensor a (viewed) tensor."""
    pad = target_ndim - x.ndim
    if pad <= 0:
        return x
    return x.reshape(tuple(x.shape) + (1,) * pad)


# ---------------------------------------------------------------------------
# Plotting (host-side; matplotlib is imported only here)
# ---------------------------------------------------------------------------

def plot_image_grid(images: np.ndarray, filename: str | None = None, ncols: int = 4,
                    cmap: str = "viridis"):
    """A grid of 2-D images, ``ncols`` a row: ``images`` [N, H, W] or
    channels-last [N, H, W, 1] (a 1-D row [N, L] is drawn 1 x L high)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    if images.ndim == 4 and images.shape[-1] == 1:
        images = images[..., 0]
    n = images.shape[0]
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(ncols * 2, nrows * 2))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(np.atleast_2d(images[i]), cmap=cmap)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
    return fig


def plot_tensor_images(data: np.ndarray, filename: str | None = None,
                       threshold: float = 0.5):
    """Plot a batch of channels-last fields [N, *spatial, C]: 2-D (and 1-D)
    through ``plot_image_grid``, 3-D as thresholded voxel scatters."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray(data)
    if data.shape[-1] == 1:
        data = data[..., 0]
    if data.ndim - 1 <= 2:
        return plot_image_grid(data, filename=filename)
    n = data.shape[0]
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig = plt.figure(figsize=(ncols * 3, nrows * 3))
    for i in range(n):
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

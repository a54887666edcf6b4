"""Synthetic rotational-spectroscopy corpus generator (the port's copy of
``rho_diffusion_tpu/data/spectro_synth.py``; numpy only, h5py inside the
writer).

Writes a physically-structured stand-in for the reference's molecular stick
spectra with its exact schema (one group per molecule holding
``transitions`` = [centers; log10 intensities] and a ``params`` row), from
rigid-rotor physics:

* line centers at nu_J = 2 B (J+1) - 4 D (J+1)^3 (rotational constant B,
  centrifugal distortion D);
* intensities follow the Boltzmann envelope (2J+1) exp(-B J(J+1) / kT),
  mapped into the log10 band [-8, -3];
* ``params`` = (B, T, D, n_lines), the generating physics.

CLI: ``python -m rho_diffusion_tpu_torch.data.spectro_synth out.h5 [-n 64]``
"""
from __future__ import annotations

import numpy as np


def rotor_transitions(
    B: float,
    T: float,
    D: float = 0.0,
    min_freq: float = 1000.0,
    max_freq: float = 32000.0,
):
    """Stick spectrum (centers, log10 intensities) of one rigid rotor."""
    # J+1 values whose lines land inside the window (ignore tiny D shift)
    j1 = np.arange(1, int(max_freq / (2.0 * B)) + 2, dtype=np.float64)
    centers = 2.0 * B * j1 - 4.0 * D * j1**3
    keep = (centers >= min_freq) & (centers <= max_freq) & (centers > 0)
    j1, centers = j1[keep], centers[keep]
    if centers.size == 0:
        raise ValueError(f"no rotor lines in window for B={B}")
    J = j1 - 1.0
    # Boltzmann envelope; kT expressed in the same units as B
    w = (2.0 * J + 1.0) * np.exp(-B * J * (J + 1.0) / max(T, 1e-6))
    w = w / w.max()
    # map into the reference's log10-intensity band [-8, -3]
    log10_int = -3.0 + np.log10(np.maximum(w, 1e-5))
    return centers, log10_int


def write_rotor_spectra_h5(
    path: str,
    n_molecules: int = 64,
    min_freq: float = 1000.0,
    max_freq: float = 32000.0,
    seed: int = 0,
) -> str:
    """Write ``n_molecules`` rigid rotors in the reference HDF5 schema."""
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for i in range(n_molecules):
            B = float(rng.uniform(250.0, 1500.0))
            T = float(rng.uniform(2e5, 4e6))  # sets which J peaks
            D = float(rng.uniform(0.0, 1e-3) * B)
            centers, logI = rotor_transitions(B, T, D, min_freq, max_freq)
            f[f"{i}/transitions"] = np.stack([centers, logI])
            f[f"{i}/params"] = np.asarray(
                [B, T, D, float(len(centers))], np.float32,
            )
    return path


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out")
    p.add_argument("-n", "--n-molecules", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    write_rotor_spectra_h5(args.out, args.n_molecules, seed=args.seed)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

"""Spectral structure metrics of 1-D rotational spectra (combs of
near-evenly spaced peaks).

The port's own copy of ``rho_diffusion_tpu/metrics/spectral.py`` (numpy
only): a rigid rotor's absorption spectrum is a comb of peaks spaced about
2B apart, so a generated spectrum is scored on its comb structure apart
from its pixel fidelity.
"""
from __future__ import annotations

import numpy as np


def peak_stats(spec: np.ndarray, smooth: int = 5, threshold: float = 0.05):
    """(number of peaks, comb regularity std/mean of their spacings) of one
    spectrum: the local maxima above ``threshold`` after a ``smooth``-bin
    box filter (which removes a sampler's per-bin speckle and leaves real
    peaks, about 3 bins wide, as they are), peaks closer than 3 bins merged.
    Fewer than 3 peaks give a regularity of nan."""
    s = np.convolve(spec, np.ones(smooth) / float(smooth), mode="same")
    pk = np.where((s[1:-1] > s[:-2]) & (s[1:-1] >= s[2:]) & (s[1:-1] > threshold))[0] + 1
    if len(pk) > 1:
        keep = [pk[0]]
        for p in pk[1:]:
            if p - keep[-1] >= 3:
                keep.append(p)
        pk = np.asarray(keep)
    if len(pk) < 3:
        return len(pk), np.nan
    sp = np.diff(pk).astype(np.float64)
    return len(pk), float(sp.std() / sp.mean())


def comb_metrics(gen: np.ndarray, real: np.ndarray) -> dict:
    """Comb structure of generated against real spectra, both [N, G]: the
    comb fraction (at least 3 peaks and regularity below 0.25) of each, the
    median regularities, and the fractions of generated bins below 0.02
    (baseline) and below -0.05 (negative)."""
    gen_stats = [peak_stats(g) for g in gen]
    real_stats = [peak_stats(r) for r in real]
    reg = np.asarray([r for _, r in gen_stats if np.isfinite(r)])
    reg_real = np.asarray([r for _, r in real_stats if np.isfinite(r)])
    return {
        "comb_fraction": float(
            np.mean([(c >= 3 and np.isfinite(r) and r < 0.25) for c, r in gen_stats])),
        "comb_fraction_real": float(
            np.mean([(c >= 3 and np.isfinite(r) and r < 0.25) for c, r in real_stats])),
        "comb_regularity_median_gen": float(np.median(reg)) if reg.size else None,
        "comb_regularity_median_real": float(np.median(reg_real)),
        "baseline_fraction_below_0.02": float((gen < 0.02).mean()),
        "negative_fraction": float((gen < -0.05).mean()),
    }

"""Physically-structured synthetic DeepGalaxy HDF5 generator (the port's
copy of ``rho_diffusion_tpu/data/galaxy_synth.py``; numpy only, h5py
inside the writer).

The real DeepGalaxy corpus (``output_bw_512.h5``) is a set of Bonsai N-body
galaxy-merger renderings: 512x512 black-and-white frames grouped
``s_<size-ratio>_m_<mass-ratio>``, one image stack and one ``t_myr`` time
axis per camera position. It is not redistributable, so this module renders
a deterministic physical stand-in with the same schema and conditioning
structure:

* two exponential-disk galaxies on a decaying inspiral orbit: separation
  and orbital phase are smooth functions of ``t`` (Myr, 300..650);
* the secondary's disk scale is ``s`` x the primary's and its luminosity
  scales with the mass ratio ``m`` (amplitude m/s^2);
* tidal response grows as the separation shrinks: a two-armed spiral on
  the primary and a bridge ridge along the separation axis;
* camera position ``c`` (0..13) rotates the view and tilts the disk.

Every frame is a pure function of ``(s, m, t, c)``.

CLI: ``python -m rho_diffusion_tpu_torch.data.galaxy_synth out.h5 [--size 512]``
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

T_MIN, T_MAX = 300.0, 650.0  # reference corpus time range, Myr


def render_merger(
    s: float,
    m: float,
    t: float,
    c: int,
    size: int = 512,
) -> np.ndarray:
    """Render one merger frame, float32 in [0, ~amplitude], shape [size, size].

    Deterministic in (s, m, t, c). The whole merger stays inside the
    central half of the frame so the dataset transform's CenterCrop(256)
    of a 512 image keeps it.
    """
    scale = size / 512.0
    # pixel grid centred on the frame
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    xx -= size / 2.0
    yy -= size / 2.0

    # camera: rotate the scene and incline the disk plane
    alpha = 2.0 * np.pi * (c % 14) / 14.0
    incl = np.deg2rad(25.0 + 3.0 * (c % 14))
    ca, sa = np.cos(alpha), np.sin(alpha)
    u = ca * xx + sa * yy
    v = (-sa * xx + ca * yy) / np.cos(incl)  # deproject the tilted plane

    # inspiral orbit: separation decays, phase winds up
    tau = np.clip((float(t) - T_MIN) / (T_MAX - T_MIN), 0.0, 1.0)
    d = 90.0 * scale * (1.0 - 0.9 * tau**1.1)
    theta = 0.7 + 2.5 * np.pi * tau
    ux, uy = np.cos(theta), np.sin(theta)
    f1, f2 = 1.0 / (1.0 + m), m / (1.0 + m)  # mass fractions
    # primary at -f2*d*u, secondary at +f1*d*u (barycentre fixed)
    p1 = (-f2 * d * ux, -f2 * d * uy)
    p2 = (f1 * d * ux, f1 * d * uy)

    r1 = np.hypot(u - p1[0], v - p1[1])
    r2 = np.hypot(u - p2[0], v - p2[1])

    R1 = 22.0 * scale
    R2 = max(float(s), 0.05) * R1
    # luminosity ~ mass at constant surface brightness: A * R^2 ~ m
    A2 = float(m) / max(float(s), 0.05) ** 2

    img = np.exp(-r1 / R1)
    # two-armed tidal spiral on the primary, driven by merger progress
    phi1 = np.arctan2(v - p1[1], u - p1[0])
    img *= 1.0 + 0.35 * tau * np.cos(2.0 * phi1 - 2.0 * theta)
    img += A2 * np.exp(-r2 / R2)

    # tidal bridge: ridge along the separation axis once the pair is close
    d_bridge = 60.0 * scale
    if d < d_bridge and d > 1e-6:
        # signed coordinates along/perpendicular to the separation axis
        along = (u - p1[0]) * ux + (v - p1[1]) * uy
        perp = -(u - p1[0]) * uy + (v - p1[1]) * ux
        frac = np.clip(along / (d * (f1 + f2)), 0.0, 1.0)
        ridge = np.exp(-0.5 * (perp / (6.0 * scale)) ** 2)
        gate = np.where((along > 0) & (along < d), 1.0, 0.0)
        img += 0.3 * np.sqrt(m) * (1.0 - d / d_bridge) * ridge * gate * (
            0.5 + 0.5 * np.cos(np.pi * (2.0 * frac - 1.0))
        )
    return img.astype(np.float32)


def write_deep_galaxy_h5(
    path: str,
    s_values: Sequence[float] = (0.25, 0.5, 1.0),
    m_values: Sequence[float] = (1.0,),
    cameras: Sequence[int] = (0,),
    t_values: Sequence[float] | None = None,
    size: int = 512,
) -> str:
    """Write an HDF5 file with the exact DeepGalaxy schema.

    Groups ``s_<s>_m_<m>`` each holding ``images_camera_<c:02d>``
    [T, size, size] uint16 and ``t_myr_camera_<c:02d>`` [T] — the layout
    ``DeepGalaxyDataset._load_all`` reads (reference deep_galaxy.py:283-300
    divides each stack by its global max, so the uint16 quantisation is
    undone at load).
    """
    import h5py

    if t_values is None:
        t_values = np.arange(T_MIN, T_MAX + 1, 5.0)
    t_values = np.asarray(t_values, np.float64)
    with h5py.File(path, "w") as f:
        for s in s_values:
            for m in m_values:
                grp = f.create_group(f"s_{s:g}_m_{m:g}")
                for c in cameras:
                    stack = np.stack(
                        [render_merger(s, m, t, c, size=size) for t in t_values],
                    )
                    stack = stack / stack.max() * 65535.0
                    grp.create_dataset(
                        f"images_camera_{c:02d}",
                        data=stack.astype(np.uint16),
                        compression="gzip",
                        compression_opts=4,
                    )
                    grp.create_dataset(f"t_myr_camera_{c:02d}", data=t_values)
    return path


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="output .h5 path")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--cameras", type=str, default="0")
    p.add_argument("--s", type=str, default="0.25,0.5,1.0")
    p.add_argument("--m", type=str, default="1.0")
    args = p.parse_args()
    write_deep_galaxy_h5(
        args.out,
        s_values=[float(x) for x in args.s.split(",")],
        m_values=[float(x) for x in args.m.split(",")],
        cameras=[int(x) for x in args.cameras.split(",")],
        size=args.size,
    )
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

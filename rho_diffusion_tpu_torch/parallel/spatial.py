"""Spatial (depth-axis) sharding of the 3-D conv stack.

Port of ``rho_diffusion_tpu/parallel/spatial.py``. The 3-D UNet resamples
only the inner two spatial dims (``ops/convolution.py``), so a volume
split along its DEPTH over the "context" ranks never needs resharding
between levels: every rank holds D/n planes at every level, and only the
convs with a depth kernel of 3 see their neighbours, through a one-plane
halo from each ring neighbour. JAX's non-cyclic ppermute delivers zeros at
the global edges, which is exactly SAME padding; ``halo_exchange`` does the
same.

The port's 3x3x3 convs (K5, ``ops/kernels/conv3d.py``, and the others of
``ops/convolution.py``) pad SAME in every dim. A haloed slab of D/n + 2
planes run through one of them and cropped by its first and last output
plane is JAX's VALID-in-depth conv of the slab (:63-75): the two cropped
planes are the only ones that read the SAME padding. The dgrad follows
through autograd (the crop's backward pads its gradient with zeros, the
halo's backward sends each plane's gradient back to the rank it came
from). At the flagship's context 2 a slab is 16 + 2 planes at every level:
12.5 % more conv work, and no resharding.

* ``halo_exchange(slabs)``: every rank's slab with its neighbours' planes;
* ``sharded_conv3d_local(x, conv)``: inside a slab rank, ``conv`` of the
  rank's haloed slab, cropped. It is the one halo conv of the port:
  ``ConvNd`` runs every 3-D conv with a depth kernel of 3 through it (the
  input conv and the head on ``conv3d_direct``, the strided Downsample on
  ``F.conv3d``, K5 elsewhere);
* ``spatial_sharded_conv3d(x, weight, mesh)``: the global entry, the
  volume's depth over the context axis (and its rows over "data" when they
  divide), each rank's slab through a ``ConvNd``'s route under
  ``parallel.spmd.run_ranks``, as the UNet runs it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from rho_diffusion_tpu_torch.parallel import spmd
from rho_diffusion_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS, DATA_AXIS, Mesh, batch_sharding)

__all__ = ["halo_exchange", "sharded_conv3d_local", "spatial_sharded_conv3d"]


def halo_exchange(slabs: list, axis: int = 1) -> list:
    """Each rank's slab padded along ``axis`` with the last plane of the
    rank before it and the first plane of the rank after it, zeros at the
    global edges; each result on its rank's device."""
    n = len(slabs)
    out = []
    for r, x in enumerate(slabs):
        size = x.shape[axis]
        left = (slabs[r - 1].narrow(axis, slabs[r - 1].shape[axis] - 1, 1).to(x.device) if r > 0
                else torch.zeros_like(x.narrow(axis, 0, 1)))
        right = (slabs[r + 1].narrow(axis, 0, 1).to(x.device) if r < n - 1
                 else torch.zeros_like(x.narrow(axis, size - 1, 1)))
        out.append(torch.cat([left, x, right], dim=axis))
    return out


def sharded_conv3d_local(x: torch.Tensor,
                         conv: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Inside a slab rank of ``spmd.run_ranks``: the conv of this rank's
    slab x [B, D/n, H, W, Cin] with one plane from each neighbour, VALID in
    depth -> [B, D/n, H', W', Cout]. ``conv`` is a SAME conv of a 5-D
    tensor with a depth kernel of 3 and depth stride 1; its first and last
    output planes, the only ones that read its SAME padding, are dropped."""
    return conv(spmd.exchange(x, halo_exchange))[:, 1:-1]


def spatial_sharded_conv3d(x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SAME 3x3x3 conv of [B, D, H, W, Cin] with D split over the
    context axis (and B over "data" when it divides, else every row on the
    first data rank's ring), each slab on its rank's device and through
    ``ConvNd``'s route, as the UNet runs it (the conv3d backend's choice).
    Exact against the unsharded conv (the halo reproduces SAME padding).
    Returns [B, D, H, W, Cout] on x's device."""
    from rho_diffusion_tpu_torch.ops.convolution import ConvNd  # it imports this module

    n_data, n = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
    if x.shape[1] % n:
        raise ValueError(f"depth {x.shape[1]} does not split over the {n} context ranks")
    if x.shape[0] % n_data:
        mesh = Mesh(mesh.devices[:1])
    with torch.device("meta"):  # only its route is used: the weights are the caller's
        layer = ConvNd(3, weight.shape[1], weight.shape[0], 3)
    placed = batch_sharding(mesh, spatial=True).place(x)

    def rank_conv(r: spmd.Rank) -> torch.Tensor:
        return layer.conv_float(placed.piece(r.data, r.context), weight.to(r.device),
                                None if bias is None else bias.to(r.device))

    outs = spmd.run_ranks(mesh, rank_conv, spatial=True)
    return torch.cat([torch.cat([y.to(x.device) for y in row], dim=1) for row in outs], dim=0)

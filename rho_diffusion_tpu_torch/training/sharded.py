"""Parameters, optimizer state and EMA split over both axes of a mesh:
ZeRO-1 or FSDP (ZeRO-3) over "data", tensor parallelism (TP) over
"context", each alone, TP with either, never ZeRO-1 with FSDP.

Port of ``shard_opt_state_zero1`` and ``shard_state_fsdp``/
``create_state_fsdp`` (``rho_diffusion_tpu/parallel/mesh.py:144-276``) and
``shard_params_for_tp`` (``rho_diffusion_tpu/parallel/tensor.py:36-52``). In JAX every leaf carries
a ``NamedSharding`` and GSPMD gathers weights, reduce-scatters gradients and
slices convs by output channel. Here one process drives every rank
(``parallel/spmd.py``) and each of those exchanges is a tensor operation
that autograd records.

A parameter's ``Leaf`` names, in torch dims of the port's layout:

* ``cdim``, its split over "context" under TP: JAX's trailing dim (a conv's
  Cout, a Dense's out, an embedding's width) for a leaf of at least two
  dims whose trailing dim divides by the context size and is at least
  ``tp_min_dim`` (``parallel.tensor.tp_spec_for``);
* ``pdim``, its split over "data" under FSDP: JAX's ``_shard_dim`` in JAX's
  layout (``zero1.jax_layout_axes``), on a dim other than ``cdim``;
* ``sdim``, the split over "data" of its optimizer state and EMA: ``pdim``
  under FSDP, ZeRO-1's dim with ``zero1``, else none.

At rest a parameter split over either axis lives only as its pieces:
piece (d, c) on ``mesh.devices[d][c]`` (index 0 on an axis it is not split
over), and the model's own parameter (and each replica's) is a placeholder
of no elements. Each rank's optimizer (one per (d, c), its own device)
holds the shards of that rank: the pieces themselves, or under ZeRO-1 its
1/N slices of them, which it updates and copies back. The EMA is split as
the optimizer state.

In a step, ``gathered`` puts into every model copy (the model and each
replica) what its ranks read:

* a leaf split over "data" only: the pieces concatenated on that copy's
  device (the FSDP all-gather); autograd's backward of the concatenation
  hands each piece its slice of the gradient summed over the ranks that
  read it (the reduce-scatter);
* a TP leaf: its context pieces, each gathered over "data" when FSDP
  splits it too, on the devices of the copy's context ranks, and a
  ``forward`` of the module's own (``column_forward``) that runs the
  module's forward once per piece on that rank's device, from the whole
  input and the piece's block of the bias, and concatenates the outputs on
  the last (channel) dim, where every layer of the port keeps its output
  channels. So each piece gets its own gradient and the input's gradient
  is summed; the layers themselves know nothing of TP.

After the step the placeholders are back. Checkpoints gather every piece
and shard on the host, in the layout of the unsharded state, so a
checkpoint moves between sharded and plain runs; ``load_params`` and
``load_state_dict`` split them again.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from rho_diffusion_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    Mesh,
    _data_axis_placer,
    canonical_device,
    replicate_state,
)
from rho_diffusion_tpu_torch.parallel.tensor import tp_dims
from rho_diffusion_tpu_torch.training.ema import ema_decay_at
from rho_diffusion_tpu_torch.training.optimizers import OptaxAdafactor
from rho_diffusion_tpu_torch.training.zero1 import _constructor_kwargs, jax_layout_axes

HOST = torch.device("cpu")


def cut(t: torch.Tensor, splits) -> torch.Tensor:
    """``t`` narrowed to part i of n along dim for each (dim, i, n) in
    ``splits`` whose dim is not None."""
    for dim, i, n in splits:
        if dim is not None:
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
    return t


def join(grid: dict, ddim: Optional[int], cdim: Optional[int], n: int, m: int,
         device) -> torch.Tensor:
    """The whole tensor from its parts ``grid[(d, c)]``, on ``device``."""
    cols = []
    for c in range(m if cdim is not None else 1):
        parts = [grid[(d, c)].to(device) for d in range(n if ddim is not None else 1)]
        cols.append(torch.cat(parts, dim=ddim) if ddim is not None else parts[0])
    return torch.cat(cols, dim=cdim) if cdim is not None else cols[0]


def placeholder(p: torch.Tensor) -> torch.Tensor:
    return torch.empty(0, dtype=p.dtype, device=p.device)


@contextlib.contextmanager
def shadowed(module: nn.Module, values: dict):
    """Inside the body ``module.<name>`` reads ``values[name]``: an instance
    attribute shadows the entry of ``module._parameters``, whose order stays
    as it is. What the names read before is back after."""
    before = {k: module.__dict__[k] for k in values if k in module.__dict__}
    module.__dict__.update(values)
    try:
        yield module
    finally:
        for k in values:
            if k in before:
                module.__dict__[k] = before[k]
            else:
                del module.__dict__[k]


def column_forward(module: nn.Module, attr: str, pieces: list, cdim: int):
    """A forward for ``module`` whose parameter ``attr`` is split by output
    channel into ``pieces`` (one per context rank, on its device, along
    ``cdim``): the module's own forward once per piece, on the piece's
    device, from the whole input and the piece's block of the bias (whole
    or gathered), concatenated on the last dim on the input's device. Each
    piece is shadowed into the module in turn, so a module's forward must
    not run on two threads at once: the data ranks run one after another,
    and TP refuses spatial sharding, whose context ranks run as threads."""
    forward = type(module).forward

    def run(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        bias = getattr(module, "bias", None)
        outs, start = [], 0
        for w in pieces:
            n = w.shape[cdim]
            values = {attr: w}
            if isinstance(bias, torch.Tensor):
                values["bias"] = bias.narrow(0, start, n).to(w.device)
            with shadowed(module, values):
                outs.append(forward(module, x.to(w.device), *args, **kwargs).to(x.device))
            start += n
        return torch.cat(outs, dim=-1)

    return run


@dataclass
class Leaf:
    """One parameter of the model and where its pieces and shards lie."""

    name: str
    module: str
    attr: str
    shape: tuple
    cdim: Optional[int]
    pdim: Optional[int]
    sdim: Optional[int]
    pieces: dict = field(default_factory=dict)
    shards: dict = field(default_factory=dict)

    @property
    def split(self) -> bool:
        """True when the parameter itself is split (its model copy is a
        placeholder)."""
        return self.cdim is not None or self.pdim is not None

    @property
    def zero1(self) -> bool:
        """True when the optimizer holds slices of the pieces (ZeRO-1)."""
        return self.sdim is not None and self.sdim != self.pdim


class ShardedOptimizer:
    """The optimizer of a state whose parameters or optimizer state are
    split over a mesh (module docstring). It stands where a ``torch.optim``
    optimizer stands (``step``, ``param_groups``, whose lr the pipeline
    sets each step, ``state``, ``state_dict``, ``load_state_dict``) and also
    owns the parameters' pieces."""

    def __init__(self, plain: torch.optim.Optimizer, state, mesh: Mesh,
                 tp_min_dim: Optional[int] = None, fsdp: bool = False, zero1: bool = False,
                 include_ema: bool = True) -> None:
        cls = type(plain)
        if issubclass(cls, OptaxAdafactor):
            raise NotImplementedError(
                "ZeRO-1, FSDP or tensor parallelism with Adafactor: its factored second "
                "moments read whole rows and columns of a leaf, which a piece does not hold")
        if fsdp and zero1:
            raise ValueError("fsdp (ZeRO-3) already shards the optimizer state: not with zero1")
        self.cls, self.kwargs = cls, _constructor_kwargs(plain)
        self.mesh, self.tp_min_dim, self.fsdp, self.zero1 = mesh, tp_min_dim, fsdp, zero1
        self.include_ema = include_ema
        self.n, self.m = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
        self.first = mesh.devices[0][0]
        model = state.model
        self.model = model
        place = _data_axis_placer(mesh)
        cdims = {} if tp_min_dim is None else tp_dims(model, mesh, tp_min_dim)
        self.leaves: list[Leaf] = []
        for mname, module in model.named_modules():
            for attr, p in module.named_parameters(recurse=False):
                name = f"{mname}.{attr}" if mname else attr
                axes = jax_layout_axes(module, attr, p)
                cdim = cdims.get(name)
                ddim = place(p, axes, blocked=() if cdim is None else (len(axes) - 1,))
                self.leaves.append(Leaf(name, mname, attr, tuple(p.shape), cdim,
                                        ddim if fsdp else None, ddim if fsdp or zero1 else None))
        self._split(plain, state)
        self.template = cls([nn.Parameter(torch.empty(0)) for _ in self.leaves], **self.kwargs)

    # -- layout ---------------------------------------------------------
    def _grid(self, leaf: Leaf, ddim: Optional[int]):
        """The keys (d, c) of a grid split over ``ddim`` and the leaf's
        ``cdim``, with each key's splits and device."""
        for d in range(self.n if ddim is not None else 1):
            for c in range(self.m if leaf.cdim is not None else 1):
                yield (d, c), ((ddim, d, self.n), (leaf.cdim, c, self.m)), self.mesh.devices[d][c]

    def _split(self, plain: torch.optim.Optimizer, state) -> None:
        """Cut the model's parameters, ``plain``'s state and the EMA into the
        leaves' pieces and shards, put placeholders into the model copies and
        move the model (its whole parameters) to the mesh's first device."""
        params = dict(self.model.named_parameters())
        states = {leaf.name: plain.state.get(params[leaf.name], {}) for leaf in self.leaves}
        for leaf in self.leaves:
            p = params[leaf.name]
            if leaf.split:
                leaf.pieces = {key: nn.Parameter(cut(p.detach(), splits).to(dev).clone())
                               for key, splits, dev in self._grid(leaf, leaf.pdim)}
            else:
                leaf.pieces = {(0, 0): p}
            leaf.shards = leaf.pieces
            if leaf.zero1:
                leaf.shards = {key: nn.Parameter(cut(p.detach(), splits).to(dev).clone())
                               for key, splits, dev in self._grid(leaf, leaf.sdim)}
        with torch.no_grad():
            for copy in (self.model, *state.replicas.values()):
                copy_params = dict(copy.named_parameters())
                for leaf in self.leaves:
                    if leaf.split:
                        q = copy_params[leaf.name]
                        q.data = placeholder(q)
        self.model.to(self.first)
        by_rank: dict = {}
        for leaf in self.leaves:
            for key, sh in leaf.shards.items():
                by_rank.setdefault(key, []).append(sh)
        self.opts = {key: self.cls(shards, **self.kwargs) for key, shards in by_rank.items()}
        self._load_states(states)
        self.ema = None if state.ema is None else GridEMA(self, state.ema)

    def _load_states(self, states: dict) -> None:
        """Each rank's optimizer state from the unsharded ``states`` (by
        parameter name)."""
        for opt in self.opts.values():
            opt.state.clear()
        for leaf in self.leaves:
            st = states.get(leaf.name)
            if not st:
                continue
            for key, splits, _ in self._grid(leaf, leaf.sdim):
                sh = leaf.shards[key]
                self.opts[key].state[sh] = {
                    k: (cut(v, splits).to(sh.device).clone()
                        if isinstance(v, torch.Tensor) and tuple(v.shape) == leaf.shape
                        else v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in st.items()}

    def _gathered_state(self, leaf: Leaf, device=HOST) -> dict:
        states = {key: self.opts[key].state.get(sh) for key, sh in leaf.shards.items()}
        first = states[(0, 0)]
        if not first:
            return {}
        out = {}
        for k, v in first.items():
            if isinstance(v, torch.Tensor) and v.shape == leaf.shards[(0, 0)].shape:
                out[k] = join({key: st[k] for key, st in states.items()}, leaf.sdim, leaf.cdim,
                              self.n, self.m, device)
            else:
                out[k] = v.clone() if isinstance(v, torch.Tensor) else v
        return out

    def bytes_at_rest(self) -> dict:
        """Per rank (d, c), the bytes of the parameter pieces, optimizer
        state and EMA it holds between steps (a leaf not split over an axis
        is held at index 0 of that axis)."""
        out = {(d, c): 0 for d in range(self.n) for c in range(self.m)}

        def add(key, t):
            out[key] += t.numel() * t.element_size()

        for leaf in self.leaves:
            for key, piece in leaf.pieces.items():
                add(key, piece)
            for key, sh in leaf.shards.items():
                if leaf.zero1:
                    add(key, sh)
                for v in self.opts[key].state.get(sh, {}).values():
                    if isinstance(v, torch.Tensor):
                        add(key, v)
            if self.ema is not None and self.include_ema:
                for key, t in self.ema.grid[leaf.name].items():
                    add(key, t)
            elif self.ema is not None:
                add((0, 0), self.ema.grid[leaf.name][(0, 0)])
        return out

    # -- the step -------------------------------------------------------
    def trained_params(self) -> list[torch.Tensor]:
        """The tensors whose gradients a step computes, each once: the model's
        whole parameters and every piece of the split ones."""
        return [piece for leaf in self.leaves for piece in leaf.pieces.values()]

    @property
    def tensor_parallel(self) -> bool:
        return any(leaf.cdim is not None for leaf in self.leaves)

    @contextlib.contextmanager
    def gathered(self, state):
        """Inside the body every model copy reads its split parameters
        gathered from the pieces, recorded by autograd (module docstring)."""
        mesh, cache = self.mesh, {}

        def whole_over_data(leaf: Leaf, c: int, device) -> torch.Tensor:
            key = (leaf.name, c, device)
            if key not in cache:
                cache[key] = join({(d, 0): leaf.pieces[(d, c)] for d in range(self.n)}
                                  if leaf.pdim is not None else {(0, 0): leaf.pieces[(0, c)]},
                                  leaf.pdim, None, self.n, 1, device)
            return cache[key]

        copies = {canonical_device(self.first): self.model, **state.replicas}
        rows = {}
        for d, row in enumerate(mesh.devices):
            for dev in row:
                rows.setdefault(dev, d)
        with contextlib.ExitStack() as swaps:
            for dev, copy in copies.items():
                modules = dict(copy.named_modules())
                row = mesh.devices[rows[dev]]
                for leaf in self.leaves:
                    if not leaf.split:
                        continue
                    module = modules[leaf.module]
                    if leaf.cdim is None:
                        values = {leaf.attr: whole_over_data(leaf, 0, dev)}
                    else:
                        values = {"forward": column_forward(
                            module, leaf.attr,
                            [whole_over_data(leaf, c, row[c]) for c in range(self.m)], leaf.cdim)}
                    swaps.enter_context(shadowed(module, values))
            yield

    @torch.no_grad()
    def step(self) -> None:
        """Each rank's optimizer updates its shards from their gradients; under
        ZeRO-1 the shards are refreshed from the pieces first (gradients
        sliced likewise) and copied back after."""
        for leaf in self.leaves:
            if not leaf.zero1:
                continue
            for key, splits, _ in self._grid(leaf, leaf.sdim):
                sh, src = leaf.shards[key], leaf.pieces[(0, key[1])]
                sh.copy_(cut(src, splits[:1]))
                sh.grad = None if src.grad is None else cut(src.grad, splits[:1]).to(
                    sh.device).contiguous()
        if getattr(next(iter(self.opts.values())), "trust_ratio", False):
            self._trust_ratio_step()
        else:
            for opt in self.opts.values():
                opt.step()
        for leaf in self.leaves:
            if not leaf.zero1:
                continue
            for key, splits, _ in self._grid(leaf, leaf.sdim):
                src, sh = leaf.pieces[(0, key[1])], leaf.shards[key]
                cut(src, splits[:1]).copy_(sh.to(src.device))
                sh.grad = None

    def _trust_ratio_step(self) -> None:
        """LAMB and LARS: each shard's update direction, then the leaf's norms
        summed over its shards, then every shard's step."""
        for leaf in self.leaves:
            parts = []
            for key, sh in leaf.shards.items():
                if sh.grad is None:
                    continue
                opt = self.opts[key]
                group = opt.param_groups[0]
                st, count = opt.begin(sh, group)
                parts.append((opt, sh, st, group, opt.direction(sh.grad, sh, st, group, count)))
            if not parts:
                continue
            u_norm = torch.sqrt(sum(torch.linalg.vector_norm(u).square().to(self.first)
                                    for *_, u in parts))
            p_norm = torch.sqrt(sum(torch.linalg.vector_norm(sh).square().to(self.first)
                                    for _, sh, *_ in parts))
            for opt, sh, st, group, u in parts:
                sh.add_(opt.finish(u, sh, st, group, u_norm.to(sh.device), p_norm.to(sh.device)))

    @property
    def param_groups(self) -> list:
        return [g for opt in self.opts.values() for g in opt.param_groups]

    # -- whole tensors --------------------------------------------------
    def full_param(self, leaf: Leaf, device=HOST) -> torch.Tensor:
        return join(leaf.pieces, leaf.pdim, leaf.cdim, self.n, self.m, device).detach()

    def full_params(self) -> dict:
        """Every split parameter, whole, on the host (by name)."""
        return {leaf.name: self.full_param(leaf) for leaf in self.leaves if leaf.split}

    @contextlib.contextmanager
    def materialized(self, model: nn.Module):
        """Inside the body ``model`` (the state's model) holds its whole
        parameters, e.g. to sample or to save them; the placeholders are back
        after."""
        params = dict(model.named_parameters())
        done = []
        try:
            with torch.no_grad():
                for leaf in self.leaves:
                    if leaf.split:
                        p = params[leaf.name]
                        p.data = self.full_param(leaf, p.device)
                        done.append(p)
            yield model
        finally:
            for p in done:
                p.data = placeholder(p)

    @torch.no_grad()
    def load_params(self, sd: Mapping) -> None:
        """Load whole parameters (a model ``state_dict``) into the pieces."""
        names = {leaf.name for leaf in self.leaves}
        buffers = set(self.model.state_dict()) - names
        if set(sd) != names | buffers:
            raise KeyError(f"parameters missing {sorted(names | buffers - set(sd))[:5]}, "
                           f"unexpected {sorted(set(sd) - names - buffers)[:5]}")
        self.model.load_state_dict({k: sd[k] for k in buffers}, strict=False)
        for leaf in self.leaves:
            full = sd[leaf.name]
            if tuple(full.shape) != leaf.shape:
                raise ValueError(f"{leaf.name}: shape {tuple(full.shape)}, expected {leaf.shape}")
            for key, splits, _ in self._grid(leaf, leaf.pdim):
                piece = leaf.pieces[key]
                piece.copy_(cut(full, splits).to(piece.device))

    # -- checkpoints ----------------------------------------------------
    @property
    def state(self) -> dict:
        """Every parameter's optimizer state, gathered on the host (keyed by
        the model's parameters)."""
        params = dict(self.model.named_parameters())
        out = {params[leaf.name]: self._gathered_state(leaf) for leaf in self.leaves}
        return {p: st for p, st in out.items() if st}

    def state_dict(self) -> dict:
        """The unsharded optimizer's ``state_dict``: every shard gathered."""
        opt = self.template
        opt.state.clear()
        for ph, leaf in zip(opt.param_groups[0]["params"], self.leaves):
            st = self._gathered_state(leaf)
            if st:
                opt.state[ph] = st
        for g in opt.param_groups:
            g["lr"] = self.param_groups[0]["lr"]
        sd = opt.state_dict()
        opt.state.clear()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Load an unsharded optimizer's ``state_dict`` and split it."""
        self.template.load_state_dict(sd)
        phs = self.template.param_groups[0]["params"]
        self._load_states({leaf.name: self.template.state.get(ph, {})
                           for ph, leaf in zip(phs, self.leaves)})
        lr = self.template.param_groups[0]["lr"]
        for g in self.param_groups:
            g["lr"] = lr
        self.template.state.clear()

    def unsharded(self) -> torch.optim.Optimizer:
        """The equivalent plain optimizer over the model's parameters, which
        must hold their whole values (``unshard_state``)."""
        opt = self.cls(self.model.parameters(), **self.kwargs)
        params = dict(self.model.named_parameters())
        for leaf in self.leaves:
            st = self._gathered_state(leaf, self.first)
            if st:
                opt.state[params[leaf.name]] = st
        for g in opt.param_groups:
            g["lr"] = self.param_groups[0]["lr"]
        return opt


class GridEMA(Mapping):
    """The EMA of a ``ShardedOptimizer``'s state, split as its optimizer
    state (or, without ``include_ema``, whole beside the first rank).
    Reading a name gathers it on the host; ``update`` moves each part toward
    its updated shard."""

    def __init__(self, owner: ShardedOptimizer, ema: Mapping) -> None:
        self.owner = owner
        self.names = [leaf.name for leaf in owner.leaves]
        self.grid: dict = {}
        self.load(ema)

    def load(self, ema: Mapping) -> None:
        owner = self.owner
        for leaf in owner.leaves:
            full = ema[leaf.name].detach()
            if owner.include_ema:
                self.grid[leaf.name] = {key: cut(full, splits).to(dev).clone()
                                        for key, splits, dev in owner._grid(leaf, leaf.sdim)}
            else:
                self.grid[leaf.name] = {(0, 0): full.to(owner.first).clone()}

    def __getitem__(self, name: str) -> torch.Tensor:
        leaf = self.owner.leaves[self.names.index(name)]
        if not self.owner.include_ema:
            return self.grid[name][(0, 0)]
        return join(self.grid[name], leaf.sdim, leaf.cdim, self.owner.n, self.owner.m, HOST)

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    @torch.no_grad()
    def update(self, step: int, decay: float) -> None:
        """One EMA step toward the updated parameters."""
        weight = float(np.float32(1.0) - np.float32(ema_decay_at(step, decay)))
        owner = self.owner
        for leaf in owner.leaves:
            grid = self.grid[leaf.name]
            if owner.include_ema:
                keys = list(grid)
                torch._foreach_lerp_([grid[k] for k in keys],
                                     [leaf.shards[k].detach() for k in keys], weight)
            else:
                target = join(leaf.shards, leaf.sdim, leaf.cdim, owner.n, owner.m, owner.first)
                grid[(0, 0)].lerp_(target, weight)


def unshard_state(state) -> torch.optim.Optimizer:
    """Put ``state`` back in plain form (whole parameters in the model and
    its replicas, the EMA a dict) and return the equivalent plain optimizer
    (with its state)."""
    opt = state.optimizer
    if isinstance(opt, ShardedOptimizer):
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for leaf in opt.leaves:
                if leaf.split:
                    p = params[leaf.name]
                    p.data = opt.full_param(leaf, p.device)
                    for replica in state.replicas.values():
                        q = dict(replica.named_parameters())[leaf.name]
                        q.data = p.data.to(q.device)
        plain = opt.unsharded()
        if state.ema is not None:
            state.ema = {k: state.ema[k].to(opt.first).clone() for k in state.ema}
        return plain
    return opt


def sharding_of(state) -> dict:
    """The options a state is sharded with now: ``tp_min_dim``, ``fsdp``,
    ``zero1`` and ``include_ema``."""
    opt = state.optimizer
    if isinstance(opt, ShardedOptimizer):
        return {"tp_min_dim": opt.tp_min_dim, "fsdp": opt.fsdp, "zero1": opt.zero1,
                "include_ema": opt.include_ema}
    return {"tp_min_dim": None, "fsdp": False, "zero1": False, "include_ema": True}


def shard_state(state, mesh: Mesh, **options):
    """Shard ``state`` over ``mesh`` with ``options`` (those of
    ``ShardedOptimizer``) in place of whatever sharding it has: the whole
    values are taken from it (gathered, if it is sharded), cut into pieces
    and shards, and the model (with its placeholders) moves to the mesh's
    first device, with a replica on each other device. Returns the state."""
    plain = unshard_state(state)
    if getattr(state, "mesh", None) is not mesh:
        state.replicas = {}
    state.optimizer = ShardedOptimizer(plain, state, mesh, **options)
    if state.ema is not None:
        state.ema = state.optimizer.ema
    if getattr(state, "mesh", None) is not mesh:
        replicate_state(state, mesh)
    return state

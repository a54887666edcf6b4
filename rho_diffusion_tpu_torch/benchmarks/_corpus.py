"""What the 2-D and 1-D quality harnesses share: the corpora, the config
edits, the trainer run and the sampling over the evaluation rows.

The JAX package's six 2-D/1-D harnesses (``benchmarks/demo_galaxy2d.py``,
``galaxy_dc_probe.py``, ``demo_spectro1d.py``, ``spectro_rescore.py``,
``demo_generalization.py``, ``demo_spectro_cond.py``) each build a synthetic
corpus, write it as HDF5, edit an example config and train it through the
config-driven ``Trainer``. Here that is written once:

* **The corpus route** (``route``). Where h5py is installed the corpus is
  written with the port's writers (``data.galaxy_synth``,
  ``data.spectro_synth``) and read through the dataset class the config
  names (``hdf5``). Without h5py (the card's host) the same items are built
  in memory (``memory``): ``GalaxyFrames`` for ``DeepGalaxyDataset`` and
  ``RotorSpectra`` for ``SpectroscopyDataset``, held bitwise against the
  datasets on the written files by the CPU tests. Rendered galaxy stacks are kept for the process
  (uint16 frames and each stack's max, divided at ``__getitem__``), so
  harnesses run one after another render each stack once
  (``clear_cache`` frees them); a large corpus renders in worker processes.
* **The recipe edits**: the budget (epochs into ``T_max``, checkpoints at
  half), the ``zero_snr`` pipeline swap (zero-terminal SNR, v-prediction,
  fixed_small, trailing DDIM) and the ``*_SMOKE`` cut exactly as the JAX
  scripts write it (width 8, one res block, no attention, a 20-step
  schedule with beta 2e-4..1e-2, fp32).
* **Training** through ``Trainer`` (``train``), the config it ran saved
  beside its checkpoints, and **sampling** with the EMA weights (the raw
  ones without EMA) over the evaluation rows in chunks, each from a
  ``torch.Generator`` seeded as the JAX script seeds its key for that chunk.
  JAX and torch draw different streams, so the numbers are the port's own.

One knob is the port's own: ``CORPUS_MAX_STEPS=N`` caps every sampler's
steps at N, DDPM's full T among them (a DDPM capped below T runs its
ancestral step on the uniform-t respaced grid, ``ddpm_respaced``); rows and
report keys then name the steps that ran. Unset, every count is the JAX
script's.

The argument parser, the report writer, the Sinkhorn scorer, the noise
baseline and the device line come from ``_ylm`` and ``_timing``.
"""
from __future__ import annotations

import importlib.util
import json
import multiprocessing
import os
import re
import threading
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from functools import cached_property
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.config import ComponentConfig, ExperimentConfig
from rho_diffusion_tpu_torch.data.deep_galaxy import DeepGalaxyDataset, default_transform
from rho_diffusion_tpu_torch.data.galaxy_synth import (
    T_MAX,
    T_MIN,
    render_merger,
    write_deep_galaxy_h5,
)
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.data.spectro_synth import rotor_transitions, write_rotor_spectra_h5
from rho_diffusion_tpu_torch.data.spectroscopy import SpectroscopyDataset
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step
from rho_diffusion_tpu_torch.diffusion.gaussian import space_timesteps
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.trainer import Trainer, swapped_weights

GALAXY_CONFIG = _ylm.REPO / "examples" / "config_deep_galaxy.json"
SPECTRO_CONFIG = _ylm.REPO / "examples" / "config_spectroscopy.json"
GALAXY_H5 = "output_bw_512.h5"
SPECTRA_H5 = "spectra.h5"
CORPUS_FILE = "corpus.json"
CONFIG_FILE = "config.json"
# the JAX scripts' smoke cut (e.g. demo_galaxy2d.py:110-116)
SMOKE_MODEL = dict(model_channels=8, num_res_blocks=1, attention_resolutions=[], num_heads=1)
SMOKE_SCHEDULE = dict(num_steps=20, beta_1=2e-4, beta_T=1e-2)
ZERO_SNR_PIPELINE = {"model_mean_type": "v_prediction", "model_var_type": "fixed_small"}


def route() -> str:
    """``hdf5`` where h5py is installed, else ``memory``."""
    return "hdf5" if importlib.util.find_spec("h5py") is not None else "memory"


def max_steps(n: int) -> int:
    """``n`` capped at ``CORPUS_MAX_STEPS`` when it is set."""
    cap = os.environ.get("CORPUS_MAX_STEPS")
    return min(int(n), int(cap)) if cap else int(n)


# ---------------------------------------------------------------------------
# The corpora in memory

_STACKS: dict = {}
_STACKS_LOCK = threading.Lock()
# a corpus of at least this many pixels renders in worker processes
PROCESS_PIXELS = 64 * 512 * 512
RENDER_WORKERS = 8


def clear_cache() -> None:
    """Free the rendered galaxy stacks."""
    with _STACKS_LOCK:
        _STACKS.clear()


def render_frames(jobs: list, size: int) -> list:
    """``render_merger(s, m, t, c, size)`` of each (s, m, c, t) job. A large
    corpus renders in RENDER_WORKERS forked processes (``render_merger`` is
    many small numpy operations, which threads run one at a time under the
    GIL; a spawned process would first import torch, which takes longer
    than the render); a small one, or one where fork is missing, in this
    process. The forked workers run numpy alone, never CUDA, as a
    DataLoader's forked workers do."""
    s, m, c, t = ([job[i] for job in jobs] for i in range(4))
    if (len(jobs) * size * size < PROCESS_PIXELS
            or "fork" not in multiprocessing.get_all_start_methods()):
        return list(map(render_merger, s, m, t, c, [size] * len(jobs)))
    with warnings.catch_warnings():
        # os.fork's warning about a multi-threaded parent: the workers take
        # no lock another thread could hold (numpy on their own arrays)
        warnings.simplefilter("ignore", DeprecationWarning)
        with ProcessPoolExecutor(max_workers=RENDER_WORKERS,
                                 mp_context=multiprocessing.get_context("fork")) as pool:
            return list(pool.map(render_merger, s, m, t, c, [size] * len(jobs),
                                 chunksize=max(len(jobs) // (4 * RENDER_WORKERS), 1)))


def galaxy_stacks(keys: list, t_values: np.ndarray, size: int) -> list:
    """The (uint16 frames, their max) of each (s, m, camera) in ``keys``: the
    stack ``write_deep_galaxy_h5`` writes for it (``render_merger`` over
    ``t_values``, scaled by its max to uint16), kept for the process."""
    tkey = tuple(float(t) for t in t_values)
    todo = [k for k in dict.fromkeys(keys) if (k, tkey, size) not in _STACKS]
    if todo:
        frames = render_frames([(*k, t) for k in todo for t in t_values], size)
        for i, k in enumerate(todo):
            stack = np.stack(frames[i * len(t_values):(i + 1) * len(t_values)])
            stack = (stack / stack.max() * 65535.0).astype(np.uint16)
            with _STACKS_LOCK:
                _STACKS[(k, tkey, size)] = (stack, np.max(stack))
    return [_STACKS[(k, tkey, size)] for k in keys]


def camera_list(camera_pos) -> list:
    """The dataset's reading of ``camera_pos`` (an int, a list, "*" or a
    quoted "3,7")."""
    if isinstance(camera_pos, int):
        return [camera_pos]
    if isinstance(camera_pos, str):
        return list(range(14)) if camera_pos == "*" else [int(c) for c in camera_pos.split(",")]
    return list(camera_pos)


class GalaxyFrames:
    """DeepGalaxyDataset's items, built in memory for a host without h5py:
    the frames ``write_deep_galaxy_h5(path, s_values, m_values, cameras,
    t_values, size)`` would write, each divided by its stack's max as the
    dataset loads them, selected by the dataset kwargs' pattern, cameras,
    ``t_lim`` and then ``t_exclude`` (after the normalisation, so a held-out
    frame is the same in every selection), then ``default_transform``;
    labels the raw (s, m, t, c) rows. Raw label rows only
    (``use_emb_as_labels`` false)."""

    def __init__(self, kwargs: dict, s_values, m_values, cameras, size: int,
                 t_values=None) -> None:
        if kwargs.get("use_emb_as_labels", True):
            raise ValueError("GalaxyFrames gives raw label rows: use_emb_as_labels false")
        self.parameter_space = DeepGalaxyDataset.parameter_space
        self.use_emb_as_labels = False
        self.transform = default_transform
        t_values = np.asarray(np.arange(T_MIN, T_MAX + 1, 5.0) if t_values is None
                              else t_values, np.float64)
        pattern = re.compile(kwargs.get("dset_name_pattern", "s_*"))
        wanted = camera_list(kwargs.get("camera_pos", (0,)))
        keep = np.ones(t_values.shape, bool)
        if kwargs.get("t_lim") is not None:
            lo, hi = np.min(kwargs["t_lim"]), np.max(kwargs["t_lim"])
            keep &= (t_values >= lo) & (t_values <= hi)
        if kwargs.get("t_exclude") is not None:
            keep &= ~np.isin(t_values, np.asarray(kwargs["t_exclude"]))
        groups = sorted((f"s_{s:g}_m_{m:g}", s, m) for s in s_values for m in m_values)
        keys, labels = [], []
        for name, s, m in groups:
            if not pattern.match(name):
                continue
            for c in wanted:
                if c not in cameras:
                    raise KeyError(f"camera {c} is not in the corpus {tuple(cameras)}")
                keys.append((s, m, c))
                t_kept = t_values[keep]
                labels.append(np.stack([np.full(t_kept.shape, float(name.split("_")[1])),
                                        np.full(t_kept.shape, float(name.split("_")[3])),
                                        t_kept, np.full(t_kept.shape, c, dtype=np.int32)], axis=1))
        if not keys:
            raise ValueError(f"no stack matched pattern {pattern.pattern!r} with cameras {wanted}")
        self.stacks = galaxy_stacks(keys, t_values, size)
        frames = np.flatnonzero(keep)
        self.rows = [(i, int(f)) for i in range(len(keys)) for f in frames]
        self.labels = np.concatenate(labels, axis=0).astype(np.float32)
        self.loaded_parameter_space = DiscreteParameterSpace(param_dict={
            k: sorted(np.unique(self.labels[:, i].astype(np.float64) if k != "c"
                                else self.labels[:, i].astype(np.int32)).tolist())
            for i, k in enumerate("smtc")})

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int):
        stack, top = self.stacks[self.rows[idx][0]]
        return self.transform(stack[self.rows[idx][1]] / top), self.labels[idx]


class RotorSpectra:
    """SpectroscopyDataset's items, built in memory for a host without
    h5py: the rotors ``write_rotor_spectra_h5(path, n_molecules, seed=seed)``
    would write (their transitions in float32, as the dataset reads them),
    each item's profile simulated with the dataset's line shape and
    linewidth draw (a locked generator seeded with the kwargs' seed); the
    kwargs' ``indices`` select a subset of the molecules, and
    ``parameter_space`` is the dataset's, over every molecule's (B, T, D,
    n_lines) row."""

    def __init__(self, kwargs: dict, n_molecules: int, seed: int) -> None:
        self.frequency_grid = np.linspace(kwargs.get("min_freq") or 1000.0,
                                          kwargs.get("max_freq") or 32000.0,
                                          kwargs.get("grid_size", 50_000), dtype=np.float32)
        rng = np.random.default_rng(seed)
        self.transitions, self.params = [], []
        for _ in range(n_molecules):
            B = float(rng.uniform(250.0, 1500.0))
            T = float(rng.uniform(2e5, 4e6))
            D = float(rng.uniform(0.0, 1e-3) * B)
            centers, log_int = rotor_transitions(B, T, D)
            self.transitions.append(np.stack([centers, log_int]).astype(np.float32))
            self.params.append(np.asarray([B, T, D, float(len(centers))], np.float32))
        indices = kwargs.get("indices")
        self.indices = list(indices) if indices is not None else None
        self._linewidth = kwargs.get("linewidth")
        self._rng = np.random.default_rng(kwargs.get("seed", 0))
        self._rng_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.transitions) if self.indices is None else len(self.indices)

    @cached_property
    def parameter_space(self) -> DiscreteParameterSpace:
        rows = np.stack(self.params)
        return DiscreteParameterSpace(param_dict={
            k: sorted(np.unique(rows[:, i]).tolist())
            for i, k in enumerate(["B", "T", "D", "n_lines"][: rows.shape[1]])})

    def sample_linewidth(self) -> float:
        return SpectroscopyDataset.sample_linewidth(self)

    def __getitem__(self, index: int) -> dict:
        if self.indices is not None:
            index = self.indices[index]
        centers, intensities = self.transitions[index]
        intensities = np.clip(intensities, -10.0, -2.0)
        profile = SpectroscopyDataset.simulate_lineprofile(
            self.frequency_grid, centers, 10.0**intensities, self.sample_linewidth())
        item = {"params": self.params[index],
                "max_int": np.asarray([10.0 ** intensities.max()], np.float32)}
        peak = profile.max()
        if peak > 0:
            profile = profile / peak
        item["spectrum"] = profile.astype(np.float32)[:, None]
        return item


def galaxy_dataset(kwargs: dict, corpus: dict, h5_path: Path, how: str):
    """DeepGalaxyDataset on ``h5_path`` (written from ``corpus`` when it is
    missing) on the ``hdf5`` route, ``GalaxyFrames`` on the ``memory`` one."""
    if how == "memory":
        return GalaxyFrames(kwargs, **corpus)
    if not Path(h5_path).exists():
        Path(h5_path).parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_deep_galaxy_h5(str(h5_path), **corpus)
        print(f"  wrote {h5_path} in {time.perf_counter() - t0:.1f}s", flush=True)
    return registry.get("datasets", "DeepGalaxyDataset")(**{**kwargs, "path": str(h5_path)})


def spectra_dataset(kwargs: dict, corpus: dict, h5_path: Path, how: str):
    """SpectroscopyDataset on ``h5_path`` (written from ``corpus`` when it
    is missing) on the ``hdf5`` route, ``RotorSpectra`` on the ``memory``
    one."""
    if how == "memory":
        return RotorSpectra(kwargs, **corpus)
    if not Path(h5_path).exists():
        Path(h5_path).parent.mkdir(parents=True, exist_ok=True)
        write_rotor_spectra_h5(str(h5_path), corpus["n_molecules"], seed=corpus["seed"])
        print(f"wrote {h5_path} ({corpus['n_molecules']} rotors)", flush=True)
    return registry.get("datasets", "SpectroscopyDataset")(**{**kwargs,
                                                               "h5_path": str(h5_path)})


def save_corpus(work: Path, kind: str, corpus: dict, how: str) -> None:
    """Record the corpus a run trained on (``corpus.json``), so a later
    harness (``galaxy_dc_probe``, ``spectro_rescore``) rebuilds it."""
    work.mkdir(parents=True, exist_ok=True)
    (work / CORPUS_FILE).write_text(json.dumps({"kind": kind, "route": how, "corpus": corpus}))


def load_corpus(work: Path, kind: str) -> dict:
    path = Path(work) / CORPUS_FILE
    if not path.exists():
        raise FileNotFoundError(f"no {CORPUS_FILE} in {work}: run the training harness first")
    saved = json.loads(path.read_text())
    if saved["kind"] != kind:
        raise ValueError(f"{path} describes a {saved['kind']} corpus, not {kind}")
    return saved["corpus"]


# ---------------------------------------------------------------------------
# The config edits

def harness_config(path: Path, epochs: int, batch: int) -> ExperimentConfig:
    """The example config with the JAX scripts' budget edits: batch, epochs
    (into the cosine schedule's ``T_max``), checkpoints at half and at the
    end, no sampling during training."""
    config = ExperimentConfig.from_json(path)
    config.training.batch_size = batch
    config.training.max_epochs = epochs
    config.training.min_epochs = 1
    config.training.sample_every_n_epochs = 10**9
    config.training.save_checkpoint_every_n_epochs = max(epochs // 2, 1)
    if config.lr_scheduler is not None:
        config.lr_scheduler.kwargs["T_max"] = epochs
    return config


def zero_snr(config: ExperimentConfig) -> None:
    """The ``zero_snr`` recipe: zero-terminal-SNR schedule, v-prediction,
    fixed_small variance (sampled with trailing DDIM)."""
    config.noise_schedule.kwargs["zero_terminal_snr"] = True
    config.pipeline = ComponentConfig(name="GaussianDiffusionPipeline",
                                      kwargs=dict(ZERO_SNR_PIPELINE))


def apply_recipe(config: ExperimentConfig, recipe: str) -> None:
    if recipe == "zero_snr":
        zero_snr(config)
    elif recipe != "reference":
        raise SystemExit(f"unknown DEMO_RECIPE {recipe!r}")


def smoke_cut(config: ExperimentConfig) -> None:
    """The JAX scripts' CPU cut: width 8, one res block, no attention, a
    20-step schedule (its 1000/T-scaled betas would reach 1), fp32."""
    config.model.kwargs.update(SMOKE_MODEL)
    config.noise_schedule.kwargs.update(SMOKE_SCHEDULE)
    config.training.dtype = "float32"


# ---------------------------------------------------------------------------
# Training and sampling

def train(config: ExperimentConfig, dataset, work: Path, device) -> tuple:
    """``Trainer.fit`` on ``dataset`` in ``work`` (resuming its checkpoints,
    as the JAX trainer does), the config saved there as ``config.json``.
    Returns (trainer, state, wall seconds, steps/s of this fit)."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    (work / CONFIG_FILE).write_text(json.dumps(config.to_dict(), indent=2))
    trainer = Trainer(config, dataset=dataset, work_dir=work, device=device)
    state = trainer.init_state()
    start = int(state.step)
    t0 = time.perf_counter()
    state = trainer.fit(state)
    _ylm.sync(trainer.device)
    wall = time.perf_counter() - t0
    steps = int(state.step) - start
    print(f"trained {config.training.max_epochs} epochs ({steps} steps) in {wall:.1f}s",
          flush=True)
    return trainer, state, wall, steps / wall if wall > 0 and steps else None


def ddpm_respaced(pipe: DDPM, shape, conds, generator, steps: int) -> torch.Tensor:
    """DDPM's ancestral sampling (``DDPM.reverse_process``: x_T, then one
    draw a step, none at the last two, the step's noise scaled by
    ``noise_factor``, clipped) on the uniform-t grid of ``steps`` of its T
    timesteps: the step's betas are those of the respaced chain,
    1 - abar[t_i] / abar[t_(i-1)], and the model sees the original t_i. At
    ``steps`` = T it is ``reverse_process``'s loop."""
    dev = pipe.device
    use = space_timesteps(len(pipe.schedule), steps)
    abar = pipe.schedule.alpha_bar_t.double().cpu().numpy()[use]
    alpha = abar / np.concatenate([[1.0], abar[:-1]])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    table = SimpleNamespace(alpha_t=f32(alpha), beta_t=f32(1.0 - alpha), alpha_bar_t=f32(abar))
    x = torch.randn(shape, generator=generator, device=dev)
    n = shape[0]
    for i in range(len(use) - 1, 0, -1):
        z = torch.randn(shape, generator=generator, device=dev).to(x.dtype) if i > 1 \
            else torch.zeros_like(x)
        eps = pipe.apply(x, torch.full((n,), int(use[i]), dtype=torch.int64, device=dev),
                         conds).to(x.dtype)
        x = ddpm_reverse_step(table, x, eps, torch.full((n,), i, dtype=torch.int64, device=dev),
                              z, noise_factor=pipe.noise_factor, clip=pipe.clip_denoised)
    return x


def draw(pipe, n: int, conds, generator, sampler: str, steps: int) -> torch.Tensor:
    """One chunk of ``n`` samples: a DDPM pipeline's full-T ancestral loop
    (``ddpm_respaced`` when ``steps`` is below T), else ``reverse_process``
    with ``sampler`` over ``steps``."""
    shape = pipe.sample_shape(n)
    if isinstance(pipe, DDPM):
        if steps < len(pipe.schedule):
            return ddpm_respaced(pipe, shape, conds, generator, steps)
        return pipe.reverse_process(shape, conds, generator=generator)["denoised"]
    return pipe.reverse_process(shape, conds, sampler=sampler, num_steps=steps,
                                generator=generator)


def sample_rows(pipe, weights: dict, n: int, batch: int, seed: Callable[[int, int], int],
                sampler: str, steps: int, labels: Optional[np.ndarray] = None,
                full_chunks: bool = False) -> tuple:
    """Samples for ``n`` rows with ``weights`` in the backbone, ``batch`` at a
    time; chunk k starting at row lo draws from a generator seeded
    ``seed(lo, k)``, conditioned on ``labels[lo:lo + batch]`` when given.
    ``full_chunks`` draws every chunk ``batch`` wide and keeps the first
    ``n`` rows (the unconditional scripts). Returns (fp32 numpy, wall s)."""
    dev = pipe.device
    out = []
    _ylm.sync(dev)
    t0 = time.perf_counter()
    with swapped_weights(pipe.backbone, weights):
        for k, lo in enumerate(range(0, n, batch)):
            conds = None if labels is None else torch.as_tensor(
                np.asarray(labels[lo:lo + batch]), device=dev)
            size = batch if full_chunks or conds is None else conds.shape[0]
            gen = torch.Generator(device=dev).manual_seed(seed(lo, k))
            out.append(_ylm.as_numpy(draw(pipe, size, conds, gen, sampler, steps)))
    _ylm.sync(dev)
    return np.concatenate(out)[:n], time.perf_counter() - t0


def sampler_name(pipe, sampler: str, steps: int) -> str:
    return f"ddpm-{steps}" if isinstance(pipe, DDPM) else f"{sampler}-{steps}"


def plots_missing() -> Optional[str]:
    """Why no PNG is written, or None where matplotlib is installed."""
    if importlib.util.find_spec("matplotlib") is None:
        return "not written: matplotlib is not installed"
    return None

"""The port's datasets against the JAX package's, on the CPU.

Mirrors tests/data/test_datasets.py and tests/data/test_wrappers_parsing.py:

* one HDF5 file written by the JAX package's ``write_deep_galaxy_h5`` and
  ``write_rotor_spectra_h5``, read by both packages' DeepGalaxyDataset and
  SpectroscopyDataset: every item and label bitwise equal, and the rebuilt
  (loaded) parameter spaces equal;
* the port's own writers write the same values, dtype and shape as JAX's,
  dataset by dataset;
* the spherical-harmonics HDF5 round trip (``to_hdf5``/``from_hdf5``), the
  MNIST idx and CIFAR-10 pickle fixtures, ``Density``'s ``normalize``,
  ``marginalize`` and ``sample`` (with a seeded generator), the DeepGalaxy
  transform pieces and the registry names, each bitwise against JAX;
* the in-memory items of ``benchmarks._corpus`` (chip_smoke.py's and the
  2-D/1-D harnesses' route on a host without h5py) bitwise against the
  port's dataset classes on the written files.
"""
import gzip
import json
import pickle
from pathlib import Path

import h5py
import numpy as np
import pytest

from rho_diffusion_tpu.data import base as jax_base
from rho_diffusion_tpu.data import deep_galaxy as jax_deep_galaxy
from rho_diffusion_tpu.data import galaxy_synth as jax_galaxy_synth
from rho_diffusion_tpu.data import spectro_synth as jax_spectro_synth
from rho_diffusion_tpu.data.deep_galaxy import DeepGalaxyDataset as JaxDeepGalaxy
from rho_diffusion_tpu.data.spectroscopy import SpectroscopyDataset as JaxSpectroscopy
from rho_diffusion_tpu.data.synthetic import SphericalHarmonicDataset as JaxSphericalHarmonics
from rho_diffusion_tpu.data.wrappers import CIFAR10Dataset as JaxCIFAR10
from rho_diffusion_tpu.data.wrappers import MNISTDataset as JaxMNIST
from rho_diffusion_tpu.registry import registry as jax_registry
from rho_diffusion_tpu_torch.data import (
    CIFAR10Dataset,
    DeepGalaxyDataset,
    Density,
    MNISTDataset,
    SpectroscopyDataset,
    SphericalHarmonicDataset,
    UnivariateDataset,
)
from rho_diffusion_tpu_torch.benchmarks import _corpus
from rho_diffusion_tpu_torch.data import deep_galaxy, galaxy_synth, spectro_synth
from rho_diffusion_tpu_torch.registry import registry

ROOT = Path(__file__).resolve().parents[1]
# a small corpus: 64^2 frames (the transform pads them to 256, then halves)
GALAXY = dict(s_values=(0.5, 1.0), m_values=(1.0, 0.5), cameras=(0, 1),
              t_values=np.arange(300.0, 400.0, 5.0), size=64)


@pytest.fixture(scope="module")
def galaxy_h5(tmp_path_factory):
    return jax_galaxy_synth.write_deep_galaxy_h5(
        str(tmp_path_factory.mktemp("galaxy") / "galaxies.h5"), **GALAXY)


@pytest.fixture(scope="module")
def spectra_h5(tmp_path_factory):
    return jax_spectro_synth.write_rotor_spectra_h5(
        str(tmp_path_factory.mktemp("spectra") / "spectra.h5"), n_molecules=6, seed=3)


def h5_datasets(path) -> dict:
    """{name: (values, dtype)} of every dataset in an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (obj[()], obj.dtype))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("which", ["galaxy", "spectra"])
def test_writers_write_what_jax_writes(tmp_path, which):
    if which == "galaxy":
        write = lambda m, p: m.write_deep_galaxy_h5(p, **GALAXY)  # noqa: E731
        mods = (jax_galaxy_synth, galaxy_synth)
    else:
        write = lambda m, p: m.write_rotor_spectra_h5(p, n_molecules=5, seed=9)  # noqa: E731
        mods = (jax_spectro_synth, spectro_synth)
    want, got = (h5_datasets(write(m, str(tmp_path / f"{i}.h5"))) for i, m in enumerate(mods))
    assert sorted(got) == sorted(want) and len(got) >= 5
    for name, (values, dtype) in want.items():
        assert got[name][1] == dtype, name
        np.testing.assert_array_equal(got[name][0], values, err_msg=name)


def test_rotor_transitions_and_render_match_jax():
    for B, T, D in ((300.0, 1e6, 0.1), (1400.0, 3e5, 0.0)):
        for got, want in zip(spectro_synth.rotor_transitions(B, T, D),
                             jax_spectro_synth.rotor_transitions(B, T, D)):
            np.testing.assert_array_equal(got, want)
    for args in ((0.5, 1.0, 450.0, 3), (1.5, 0.25, 640.0, 13)):
        np.testing.assert_array_equal(galaxy_synth.render_merger(*args, size=96),
                                      jax_galaxy_synth.render_merger(*args, size=96))


def assert_items_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        if isinstance(want, dict):
            assert list(got) == list(want)
            got, want = [got[k] for k in want], [want[k] for k in want]
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kwargs", [
    dict(use_emb_as_labels=False, dset_name_pattern="s_0.5_*", camera_pos=[0],
         t_lim=[310, 350]),
    dict(use_emb_as_labels=False, dset_name_pattern="s_.*", camera_pos=[0, 1]),
    dict(use_emb_as_labels=True, dset_name_pattern="s_.*", camera_pos=0),
    dict(use_emb_as_labels=False, camera_pos="0,1", t_exclude=[310.0, 330.0]),
    dict(use_emb_as_labels=False, camera_pos="1", t_lim=[390, 320]),
], ids=["pattern-t_lim", "two-cameras", "hash-labels", "quoted-cameras-t_exclude",
        "quoted-camera-reversed-t_lim"])
def test_deep_galaxy_items_bitwise(galaxy_h5, kwargs):
    got, want = DeepGalaxyDataset(galaxy_h5, **kwargs), JaxDeepGalaxy(galaxy_h5, **kwargs)
    assert_items_equal(got, want)
    assert got.loaded_parameter_space.parameters == want.loaded_parameter_space.parameters
    assert got.num_classes == want.num_classes
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.parameter_space.parameters == want.parameter_space.parameters
    assert type(got).parameter_space is DeepGalaxyDataset.parameter_space  # class-level


def test_deep_galaxy_no_match_raises(galaxy_h5):
    with pytest.raises(ValueError, match="no datasets matched"):
        DeepGalaxyDataset(galaxy_h5, dset_name_pattern="nope_.*")


@pytest.mark.parametrize("kwargs", [
    dict(grid_size=512), dict(grid_size=300, linewidth=50.0),
    dict(grid_size=256, linewidth=(2.0, 0.5), seed=4, min_freq=2000.0, max_freq=20000.0),
    dict(grid_size=128, linewidth=40.0, indices=[4, 0, 2]),
], ids=["random-width", "fixed-width", "width-distribution", "indices"])
def test_spectroscopy_items_bitwise(spectra_h5, kwargs):
    """Items read in order (the linewidth draws come from one locked
    generator per dataset, so both draw the same widths)."""
    got, want = SpectroscopyDataset(spectra_h5, **kwargs), JaxSpectroscopy(spectra_h5, **kwargs)
    assert_items_equal(got, want)
    assert got.parameter_space.parameters == want.parameter_space.parameters
    np.testing.assert_array_equal(got.frequency_grid, want.frequency_grid)
    assert isinstance(got, UnivariateDataset)


def test_lineprofile_matches_jax():
    grid = np.linspace(0, 100, 1001, dtype=np.float32)
    args = (np.array([50.0, 20.0, 300.0]), np.array([2.0, 0.5, 1.0]), 1.5)
    np.testing.assert_array_equal(SpectroscopyDataset.simulate_lineprofile(grid, *args),
                                  JaxSpectroscopy.simulate_lineprofile(grid, *args))
    empty = SpectroscopyDataset.simulate_lineprofile(grid, np.array([500.0]), np.array([2.0]), 1.0)
    np.testing.assert_array_equal(empty, 0.0)


@pytest.mark.parametrize("use_emb_as_labels", [True, False])
def test_spherical_harmonic_hdf5_round_trip(tmp_path, use_emb_as_labels):
    """Both packages' to_hdf5 write the same file from the same seed, and
    each from_hdf5 reads back the same items."""
    kw = dict(max_l=3, grid_el=8, length=6, random_seed=11)
    SphericalHarmonicDataset(**kw).to_hdf5(tmp_path / "port.h5", num_samples=5)
    JaxSphericalHarmonics(**kw).to_hdf5(tmp_path / "jax.h5", num_samples=5)
    want = h5_datasets(tmp_path / "jax.h5")
    for name, (values, dtype) in h5_datasets(tmp_path / "port.h5").items():
        assert want[name][1] == dtype
        np.testing.assert_array_equal(values, want[name][0])
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert int(f.attrs["max_l"]) == 3 and json.loads(f.attrs["grid"]) == {"el": 8}
    got = SphericalHarmonicDataset.from_hdf5(tmp_path / "port.h5",
                                             use_emb_as_labels=use_emb_as_labels)
    assert len(got) == 5 and got.max_l == 3
    assert_items_equal(got, JaxSphericalHarmonics.from_hdf5(
        tmp_path / "jax.h5", use_emb_as_labels=use_emb_as_labels))
    assert got.loaded_parameter_space.parameters == {}


def test_spherical_harmonic_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        SphericalHarmonicDataset(max_l=2, h5_path=tmp_path / "absent.h5")


def _write_idx(path, arr, magic, opener=open):
    with opener(path, "wb") as f:
        f.write(magic.to_bytes(4, "big"))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture()
def mnist_root(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (10, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, (10,), dtype=np.uint8)
    _write_idx(tmp_path / "train-images-idx3-ubyte", imgs, 0x803)
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labels, 0x801)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte.gz", imgs[::-1], 0x803, gzip.open)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte.gz", labels[::-1], 0x801, gzip.open)
    return tmp_path


@pytest.fixture()
def cifar_root(tmp_path):
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (3, 3 * 32 * 32), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, 3).tolist()}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(batch, f)
    return tmp_path


@pytest.mark.parametrize("which,train", [("mnist", True), ("mnist", False), ("cifar", True),
                                         ("cifar", False)],
                         ids=["mnist-train", "mnist-t10k-gz", "cifar-train", "cifar-test"])
def test_wrappers_parse_fixtures(request, which, train):
    root = request.getfixturevalue(f"{which}_root")
    cls, jax_cls = (MNISTDataset, JaxMNIST) if which == "mnist" else (CIFAR10Dataset, JaxCIFAR10)
    got, want = cls(root=str(root), train=train), jax_cls(root=str(root), train=train)
    assert len(got) == (10 if which == "mnist" else (15 if train else 3))
    assert_items_equal(got, want)
    img, _ = got[0]
    assert img.shape == ((28, 28, 1) if which == "mnist" else (32, 32, 3))
    assert -1.0 <= img.min() and img.max() <= 1.0
    assert got.parameter_space.parameters == {"labels": list(range(10))}


@pytest.mark.parametrize("name", ["MNISTDataset", "CIFAR10Dataset"])
def test_wrappers_raise_on_missing_files(tmp_path, name):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        registry.get("datasets", name)(root=str(tmp_path / "missing"))


def test_registry_names_match_jax():
    for name in ("DeepGalaxyDataset", "SpectroscopyDataset", "SphericalHarmonicDataset",
                 "MNISTDataset", "CIFAR10Dataset"):
        assert registry.get("datasets", name).__name__ == \
            jax_registry.get("datasets", name).__name__
    assert registry.get("datasets", "DeepGalaxyDataset") is DeepGalaxyDataset


def test_density_methods_match_jax():
    rng = np.random.default_rng(2)
    field = rng.normal(size=(5, 6, 7))
    got, want = Density(field, coords=np.arange(5)), jax_base.Density(field, coords=np.arange(5))
    np.testing.assert_array_equal(got.normalize(), want.normalize())
    assert got.normalize().coords is got.coords
    np.testing.assert_array_equal(got.marginalize((0, 2)), want.marginalize((0, 2)))
    np.testing.assert_array_equal(got.sample(50, np.random.default_rng(3)),
                                  want.sample(50, np.random.default_rng(3)))
    assert got.sample(4, np.random.default_rng(0)).shape == (4, 3)
    zero = Density(np.zeros((2, 2)))
    assert zero.normalize() is zero
    with pytest.raises(ValueError, match="all-zero"):
        zero.sample(1)


def test_transform_pieces_match_jax():
    rng = np.random.default_rng(4)
    for img in (rng.uniform(size=(300, 310)), rng.uniform(size=(100, 90)),
                rng.uniform(size=(512, 512, 2))):
        np.testing.assert_array_equal(deep_galaxy.default_transform(img),
                                      jax_deep_galaxy.default_transform(img))
        np.testing.assert_array_equal(deep_galaxy.center_crop(img, 64),
                                      jax_deep_galaxy.center_crop(img, 64))
        np.testing.assert_array_equal(deep_galaxy.downscale_2x(img, 3),
                                      jax_deep_galaxy.downscale_2x(img, 3))


def test_chip_smoke_galaxy_frames_are_the_datasets_items(tmp_path):
    """The items of a host without h5py (``benchmarks._corpus.GalaxyFrames``,
    which chip_smoke's data phase uses: the frames rendered and quantised in
    memory) against DeepGalaxyDataset on
    the file the port's writer writes from the same corpus, with the
    config's dataset kwargs."""
    corpus = dict(s_values=(0.25, 1.0), m_values=(1.0,), cameras=(0,), size=64)
    kwargs = json.loads((ROOT / "examples" / "config_deep_galaxy.json").read_text())["dataset"][
        "kwargs"]
    path = galaxy_synth.write_deep_galaxy_h5(str(tmp_path / "g.h5"), **corpus)
    frames = _corpus.GalaxyFrames(kwargs, **corpus)
    dataset = DeepGalaxyDataset(**{**kwargs, "path": path})
    assert len(frames) == 2 * 25
    assert_items_equal(frames, dataset)
    assert frames.parameter_space is DeepGalaxyDataset.parameter_space


def test_chip_smoke_rotor_spectra_are_the_datasets_items(tmp_path):
    """``benchmarks._corpus.RotorSpectra`` (chip_smoke's data phase's)
    against SpectroscopyDataset on the
    file the port's writer writes from the same corpus (the config's
    4096-point grid; items read in order, as the widths are drawn in
    order)."""
    kwargs = json.loads((ROOT / "examples" / "config_spectroscopy.json").read_text())["dataset"][
        "kwargs"]
    path = spectro_synth.write_rotor_spectra_h5(str(tmp_path / "s.h5"), n_molecules=5, seed=2)
    spectra = _corpus.RotorSpectra(kwargs, n_molecules=5, seed=2)
    assert_items_equal(spectra, SpectroscopyDataset(**{**kwargs, "h5_path": path}))
    assert spectra[0]["spectrum"].shape == (4096, 1)

"""The port's native (C++) spherical-harmonics generator against the JAX
package's, on the CPU.

Mirrors tests/data/test_native_ylm.py. The normalised field is
tie-sensitive (the reference's complex min-max picks its min and max points
by exact comparisons), so the port's native field is held against JAX's
native field, not against scipy: bitwise normalised, and to 1e-6
unnormalised (both also against scipy's closed form there). The port builds
its library with g++ into ``build/native/`` at the root of the checkout.
JAX's library is built from a copy of its source in a temporary directory,
so the test writes nothing under ``rho_diffusion_tpu/``. Skips only where
g++ is missing, as JAX's test does.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

import rho_diffusion_tpu.native as jax_native
from rho_diffusion_tpu.data.synthetic import SphericalHarmonicDataset as JaxSphericalHarmonics
from rho_diffusion_tpu.data.synthetic import _legacy_sph_harm, make_spherical_grid
from rho_diffusion_tpu_torch import native
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE = ROOT / "rho_diffusion_tpu" / "native"
PAIRS = [(0, 0), (1, 1), (2, -1), (3, 2), (4, 0), (5, -4), (8, 8)]


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """JAX's ``ylm_field_native`` on a library built from its source in a
    temporary directory (its own build rule, its own flags)."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build libylm")
    tmp = tmp_path_factory.mktemp("jax_native")
    shutil.copy2(JAX_NATIVE / "ylm.cpp", tmp / "ylm.cpp")
    saved = (jax_native._NATIVE_DIR, jax_native._LIB, jax_native._BUILD_FAILED)
    jax_native._NATIVE_DIR, jax_native._LIB, jax_native._BUILD_FAILED = tmp, None, False
    try:
        assert jax_native.get_ylm_lib() is not None
        yield jax_native.ylm_field_native
    finally:
        jax_native._NATIVE_DIR, jax_native._LIB, jax_native._BUILD_FAILED = saved


@pytest.fixture(scope="module")
def port_lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build libylm")
    before = {p: p.stat().st_mtime_ns for p in JAX_NATIVE.iterdir()}
    lib = native.get_ylm_lib()
    assert lib is not None
    yield lib
    assert {p: p.stat().st_mtime_ns for p in JAX_NATIVE.iterdir()} == before


def test_library_is_built_into_build_native(port_lib):
    path = native.library_path()
    assert path.is_file() and path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libylm-") and path.suffix == ".so"
    assert Path(port_lib._name) == path
    assert not list(Path(native.__file__).parent.glob("*.so"))


@pytest.mark.parametrize("l,m", PAIRS)
def test_normalized_field_bitwise_jax_native(port_lib, jax_lib, l, m):  # noqa: E741
    for n in (8, 16):
        g = np.linspace(-2.0, 2.0, n)
        got = native.ylm_field_native(g, g, g, m=m, l=l)
        want = jax_lib(g, g, g, m=m, l=l)
        assert got.dtype == np.float32 and got.shape == (n, n, n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l,m", PAIRS)
def test_unnormalized_field_matches_jax_native_and_scipy(port_lib, jax_lib, l, m):  # noqa: E741
    g = np.linspace(-2.0, 2.0, 16)
    got = native.ylm_field_native(g, g, g, m=m, l=l, normalize=False)
    np.testing.assert_allclose(got, jax_lib(g, g, g, m=m, l=l, normalize=False), atol=1e-6)
    _, theta, phi = make_spherical_grid(g, g, g)
    xg, yg, zg = np.meshgrid(g, g, g, indexing="xy")
    r = np.sqrt(xg**2 + yg**2 + zg**2)
    np.testing.assert_allclose(got, np.abs(_legacy_sph_harm(abs(m), l, theta, phi) * r),
                               atol=1e-6)


def test_dataset_native_path_matches_jax(port_lib, jax_lib):
    """``use_native=True``: the same (l, m) draws and the same native
    fields as the JAX package's dataset."""
    kw = dict(max_l=4, grid_el=8, length=10, use_native=True, random_seed=5)
    got, want = SphericalHarmonicDataset(**kw), JaxSphericalHarmonics(**kw)
    for i in range(10):
        (x, emb), (xw, embw) = got[i], want[i]
        assert x.shape == (8, 8, 8, 1) and x.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(x), np.asarray(xw))
        np.testing.assert_array_equal(emb, embw)
    assert got._field_cache  # computed once per (l, m)


def test_invalid_lm_rejected(port_lib):
    g = np.linspace(-2.0, 2.0, 8)
    with pytest.raises(ValueError, match="code 2"):
        native.ylm_field_native(g, g, g, m=5, l=2)
    with pytest.raises(ValueError, match="cubic"):
        native.ylm_field_native(g, g[:4], g, m=0, l=1)


def test_without_a_toolchain_the_scipy_path_is_taken(monkeypatch, tmp_path):
    """No g++: ``get_ylm_lib`` is None, ``ylm_field_native`` None, and a
    ``use_native`` dataset computes scipy's fields."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "native")
    native.get_ylm_lib.cache_clear()
    try:
        assert native.get_ylm_lib() is None
        g = np.linspace(-2.0, 2.0, 8)
        assert native.ylm_field_native(g, g, g, m=0, l=1) is None
        kw = dict(max_l=3, grid_el=8, length=4, random_seed=1)
        got = SphericalHarmonicDataset(use_native=True, **kw)
        want = SphericalHarmonicDataset(use_native=False, **kw)
        for i in range(4):
            np.testing.assert_array_equal(np.asarray(got[i][0]), np.asarray(want[i][0]))
        assert not (tmp_path / "native").exists() or not list((tmp_path / "native").glob("*.so"))
    finally:
        native.get_ylm_lib.cache_clear()

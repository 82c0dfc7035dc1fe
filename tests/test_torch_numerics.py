"""repro_torch.core.numerics against repro.core.numerics: the softplus pair
on a sigma grid from 1e-4 to 1e4, the wire-dtype round trips, and the f32
structural no-op."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import numerics as jn  # noqa: E402
from repro_torch.core import numerics as tn  # noqa: E402

SIGMA_GRID = np.logspace(-4, 4, 257).astype(np.float32)


def test_softplus_matches_jax_on_rho_grid():
    rho = np.linspace(-60.0, 60.0, 2001).astype(np.float32)
    want = np.asarray(jn.softplus(jnp.asarray(rho)))
    got = tn.softplus(torch.from_numpy(rho)).numpy()
    # fp32 transcendental implementations differ by at most a few ulp
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_softplus_inv_matches_jax_on_sigma_grid():
    want = np.asarray(jn.softplus_inv(jnp.asarray(SIGMA_GRID)))
    got = tn.softplus_inv(torch.from_numpy(SIGMA_GRID)).numpy()
    assert np.all(np.isfinite(got))
    # |softplus_inv| ~ log(sigma) at tiny sigma: compare absolutely there
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_softplus_inv_round_trips_at_extreme_sigma():
    x = tn.softplus_inv(torch.from_numpy(SIGMA_GRID))
    back = tn.softplus(x).numpy()
    np.testing.assert_allclose(back, SIGMA_GRID, rtol=1e-5)
    # the naive log1p(-exp(-y)) form is -inf here; the expm1 form is not
    tiny = torch.tensor([1e-30], dtype=torch.float32)
    assert torch.isfinite(tn.softplus_inv(tiny)).all()


@pytest.mark.parametrize("wire", ["bf16", "f16"])
def test_wire_roundtrip_matches_jax(wire):
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
        [0.0, -0.0, 65504.0, 65520.0, 1e30, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)
    want = np.asarray(jn.wire_roundtrip(jnp.asarray(x), wire))
    got = tn.wire_roundtrip(torch.from_numpy(x), wire)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wire", [None, "f32", torch.float32])
def test_wire_roundtrip_f32_is_the_same_object(wire):
    x = torch.randn(7)
    assert tn.wire_roundtrip(x, wire) is x


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_wire_error_bound_and_names_match_jax(wire):
    assert tn.wire_error_bound(wire) == jn.wire_error_bound(wire)
    assert tn.wire_itemsize(wire) == jn.wire_itemsize(wire)
    assert tn.wire_dtype_name(tn.canonical_wire_dtype(wire)) == wire


def test_unknown_wire_dtype_rejected():
    with pytest.raises(ValueError):
        tn.canonical_wire_dtype("f64")
    with pytest.raises(ValueError):
        tn.canonical_wire_dtype(torch.float64)

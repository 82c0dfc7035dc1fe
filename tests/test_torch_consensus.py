"""The eq. (6) consensus and payload-validity wrappers of repro_torch against
the JAX package: the plain versions (what a CPU tensor runs) vs the Pallas
kernels in interpret mode and the XLA references, at every wire dtype.

Tolerances: at f32, rtol 1e-6 / atol 1e-6 — only the fp32 reduction order
of ``W @ prec`` differs.  At bf16/f16 one wire ulp (the dtype's eps,
relative to the output scale), because a one-ulp fp32 difference in prec can
flip a rounding tie.  Validity is bit-equal.

The CUDA kernels themselves run only on the card: see
tests/test_torch_kernels_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flat as jflat  # noqa: E402
from repro.core.graphs import grid_w, star_w  # noqa: E402
from repro.kernels import consensus as jk  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

WIRE_EPS = {"f32": 0.0, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}


def _w(n, rng):
    if n == 9:
        return grid_w(3, 3).astype(np.float32)
    w = rng.random((n, n)).astype(np.float32) + 0.05
    return w / w.sum(axis=1, keepdims=True)


def _posterior(n, p, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    # sigma from ~1e-2 to ~1: precisions stay inside f16's range
    rho = rng.uniform(-4.5, 0.5, size=(n, p)).astype(np.float32)
    return _w(n, rng), mean, rho


def _assert_eq6_close(got, want, wire):
    (gm, gr), (wm, wr) = got, want
    if wire == "f32":
        np.testing.assert_allclose(gm, wm, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gr, wr, rtol=1e-6, atol=1e-6)
    else:
        u = WIRE_EPS[wire]
        np.testing.assert_allclose(gm, wm, rtol=u, atol=u * np.abs(wm).max())
        np.testing.assert_allclose(gr, wr, rtol=u, atol=u * np.abs(wr).max())


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,p", [(1, 5), (4, 300), (9, 4099)])
def test_plain_consensus_matches_pallas_interpret(n, p, wire):
    W, mean, rho = _posterior(n, p, seed=n * 1000 + p)
    jm, jr = jk.consensus_fused_network(
        jnp.asarray(W), jnp.asarray(mean), jnp.asarray(rho),
        block=1024, interpret=True, wire_dtype=wire,
    )
    tm, tr = tk.consensus_fused_network(
        torch.from_numpy(W), torch.from_numpy(mean), torch.from_numpy(rho), wire_dtype=wire,
    )
    _assert_eq6_close((tm.numpy(), tr.numpy()), (np.asarray(jm), np.asarray(jr)), wire)


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_consensus_flat_matches_jax_reference(wire):
    W, mean, rho = _posterior(4, 5000, seed=11)
    W = star_w(3, 0.5).astype(np.float32)
    jm, jr = jflat.consensus_flat_reference(
        jnp.asarray(mean), jnp.asarray(rho), jnp.asarray(W), block=1024, wire_dtype=wire,
    )
    layout = tflat.FlatLayout.for_pytree({"w": torch.zeros(5000)})
    post = tflat.FlatPosterior(torch.from_numpy(mean), torch.from_numpy(rho), layout)
    out = tflat.consensus_flat(post, torch.from_numpy(W.astype(np.float64)), wire_dtype=wire)
    _assert_eq6_close((out.mean.numpy(), out.rho.numpy()), (np.asarray(jm), np.asarray(jr)), wire)
    ref = tflat.consensus_flat_reference(post.mean, post.rho, torch.from_numpy(W), wire)
    np.testing.assert_array_equal(out.mean.numpy(), ref[0].numpy())


def _poisoned(n=6, p=700, seed=5):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(n, p)).astype(np.float32)
    rho = rng.uniform(-3.0, 0.5, size=(n, p)).astype(np.float32)
    mean[1, 17] = np.nan           # NaN mean -> NaN pm
    rho[2, 300] = np.inf           # sigma inf -> prec 0 (not > 0)
    rho[3, 5] = -np.inf            # sigma 0 -> prec inf
    mean[4, 699] = 1e30            # huge but finite pm
    rho[5, 42] = -6.0              # prec ~ 1.6e5: overflows f16 only
    return mean, rho


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_payload_validity_bit_equal_to_jax(wire):
    mean, rho = _poisoned()
    want_xla = np.asarray(jflat.payload_validity(
        jnp.asarray(mean), jnp.asarray(rho), wire_dtype=wire, mode="xla"))
    want_pallas = np.asarray(jflat.payload_validity(
        jnp.asarray(mean), jnp.asarray(rho), wire_dtype=wire, mode="interpret", block=256))
    got = tflat.payload_validity(torch.from_numpy(mean), torch.from_numpy(rho), wire_dtype=wire)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    assert got.numpy().tolist()[:5] == [True, False, False, False, False]
    assert bool(got[5]) == (wire != "f16")


def test_payload_validity_bound_compares_in_float32():
    mean = np.zeros((2, 3), np.float32)
    rho = np.zeros((2, 3), np.float32)
    mean[1, 0] = np.float32(1e20) / np.float32(1.0 / np.log(2.0) ** 2)
    want = np.asarray(jflat.payload_validity(jnp.asarray(mean), jnp.asarray(rho), mode="xla"))
    got = tflat.payload_validity(torch.from_numpy(mean), torch.from_numpy(rho))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    dispatch.reset_launch_counts()
    W, mean, rho = _posterior(4, 300, seed=2)
    out = tk.consensus_fused_network(torch.from_numpy(W), torch.from_numpy(mean),
                                     torch.from_numpy(rho))
    ref = tk.consensus_network_plain(torch.from_numpy(W), torch.from_numpy(mean),
                                     torch.from_numpy(rho))
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    tk.payload_validity_fused(torch.from_numpy(mean), torch.from_numpy(rho), bound=1e20)
    assert dispatch.launch_counts() == dict.fromkeys(dispatch.KERNELS, 0)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: resolve_device('cuda') succeeds")
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.resolve_device("cuda")
    assert dispatch.resolve_device("cpu").type == "cpu"


def test_kernel_library_is_not_built_at_import():
    assert dispatch._lib is None or torch.cuda.is_available()

"""The float tile kernels of the PyTorch port and the weight plane, against
the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas
``bvss_spmm_w``, ``bvss_spmm_t`` and ``bvss_spmm_minplus`` (in interpret
mode, as its own tests run them) and through the port's entry points on
CPU tensors, which run their PyTorch twins.  The weighted sums are held to
the reference's own tolerance, rtol 1e-6 (``tests/test_analytics.py``:
the reference contracts on its matrix unit, the twin adds one column at a
time); the min-plus product, every operation of which is exactly rounded,
must be equal.  The weight plane and ``prepare(weights=)`` are compared
byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.bvss import build_weight_plane as j_build_weight_plane
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro.kernels import bvss_spmm_minplus as j_minplus
from repro.kernels import bvss_spmm_t as j_spmm_t
from repro.kernels import bvss_spmm_w as j_spmm_w
from repro_torch.core.bvss import build_weight_plane, weight_plane_to_device
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import (bvss_spmm_minplus, bvss_spmm_minplus_local,
                                 bvss_spmm_t, bvss_spmm_t_local, bvss_spmm_w,
                                 bvss_spmm_w_local)
from repro_torch.kernels.ref import (bvss_spmm_minplus_ref, bvss_spmm_t_ref,
                                     bvss_spmm_w_ref)

SHAPES = [(1, 1), (5, 3), (37, 9), (130, 8)]


def u32(rng, shape):
    """Random uint32 words with all-ones and bit-31-only words mixed in."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    return w


def t32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def families(gen, from_edges):
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(9, 11),
        "star": gen.star(48),
        "path": from_edges(60, np.arange(59), np.arange(1, 60)),
        "clustered": gen.clustered(3, 16, seed=4),
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)


def dyadic(rng, m):
    return (rng.integers(1, 128, m) / 32.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the twins against the reference kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sigma", [1, 4, 8, 32])
@pytest.mark.parametrize("B,S", SHAPES)
def test_weighted_twins_match_reference_kernels(sigma, B, S):
    rng = np.random.default_rng(sigma * 100 + B + S)
    spw = 32 // sigma
    masks = u32(rng, (B, 32))
    xv = rng.random((B, sigma, S), dtype=np.float32)
    hv = rng.random((B, spw, 32, S), dtype=np.float32)
    want_w = np.asarray(j_spmm_w(jnp.asarray(masks), jnp.asarray(xv),
                                 sigma=sigma, interpret=True))
    want_t = np.asarray(j_spmm_t(jnp.asarray(masks), jnp.asarray(hv),
                                 sigma=sigma, interpret=True))
    got_w = bvss_spmm_w(t32(masks), torch.from_numpy(xv), sigma=sigma)
    got_t = bvss_spmm_t(t32(masks), torch.from_numpy(hv), sigma=sigma)
    assert got_w.dtype == got_t.dtype == torch.float32
    assert tuple(got_w.shape) == (B, spw, 32, S)
    assert tuple(got_t.shape) == (B, sigma, S)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6)


@pytest.mark.parametrize("sigma", [1, 4, 8, 32])
@pytest.mark.parametrize("B,S", SHAPES)
def test_minplus_twin_equals_reference_kernel(sigma, B, S):
    """+inf weights and distances included: equal, no NaN."""
    rng = np.random.default_rng(sigma * 10 + B * S)
    spw = 32 // sigma
    masks = u32(rng, (B, 32))
    wv = rng.uniform(0.5, 4.0, (B, spw, 32, sigma)).astype(np.float32)
    wv[rng.random(wv.shape) < 0.2] = np.inf
    xv = rng.uniform(0.0, 9.0, (B, sigma, S)).astype(np.float32)
    xv[rng.random(xv.shape) < 0.3] = np.inf
    want = np.asarray(j_minplus(jnp.asarray(masks), jnp.asarray(wv),
                                jnp.asarray(xv), sigma=sigma,
                                interpret=True))
    got = bvss_spmm_minplus(t32(masks), torch.from_numpy(wv),
                            torch.from_numpy(xv), sigma=sigma).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any()


def test_minplus_empty_slice_gives_inf():
    masks = np.zeros((2, 32), np.uint32)
    masks[1, 0] = 0x3                                   # slice 0: bits 0, 1
    wv = np.full((2, 4, 32, 8), 2.0, np.float32)
    xv = np.zeros((2, 8, 3), np.float32)
    xv[1, 1] = 0.5
    got = bvss_spmm_minplus(t32(masks), torch.from_numpy(wv),
                            torch.from_numpy(xv), sigma=8).numpy()
    assert np.isinf(got[0]).all()
    np.testing.assert_array_equal(got[1, 0, 0], [2.0, 2.0, 2.0])
    assert np.isinf(got[1, 0, 1:]).all() and np.isinf(got[1, 1:]).all()


def test_twins_sum_in_ascending_order():
    """The twins add one column (row) at a time in ascending order, the
    order the CUDA kernels use: equal to a float32 loop in numpy."""
    rng = np.random.default_rng(7)
    sigma, B, S = 8, 6, 3
    masks = u32(rng, (B, 32))
    xv = rng.standard_normal((B, sigma, S)).astype(np.float32)
    got = bvss_spmm_w_ref(t32(masks), torch.from_numpy(xv), sigma).numpy()
    want = np.zeros((B, 4, 32, S), np.float32)
    for b in range(B):
        for j in range(4):
            for lane in range(32):
                for i in range(sigma):
                    if (int(masks[b, lane]) >> (sigma * j + i)) & 1:
                        want[b, j, lane] += xv[b, i]
    np.testing.assert_array_equal(got, want)


def test_local_forms_gather_columns_and_rows():
    rng = np.random.default_rng(3)
    sigma, B, S, n_sets = 4, 7, 2, 5
    masks = t32(u32(rng, (B, 32)))
    sets = torch.from_numpy(rng.integers(0, n_sets, B).astype(np.int32))
    xg = torch.from_numpy(rng.random((n_sets * sigma, S), dtype=np.float32))
    cols = sets.long()[:, None] * sigma + torch.arange(sigma)
    assert torch.equal(bvss_spmm_w_local(masks, sets, xg, sigma=sigma),
                       bvss_spmm_w_ref(masks, xg[cols], sigma))
    wv = torch.rand((B, 8, 32, sigma))
    assert torch.equal(
        bvss_spmm_minplus_local(masks, wv, sets, xg, sigma=sigma),
        bvss_spmm_minplus_ref(masks, wv, xg[cols], sigma))
    rows = torch.from_numpy(rng.integers(0, 20, (B, 8, 32)).astype(np.int32))
    hrows = torch.rand((20, S))
    assert torch.equal(bvss_spmm_t_local(masks, rows, hrows, sigma=sigma),
                       bvss_spmm_t_ref(masks, hrows[rows.long()], sigma))
    calls = []
    bvss_spmm_w_local(masks, sets, xg, sigma=sigma,
                      impl=lambda m, x, sigma: calls.append(x.shape))
    assert calls == [(B, sigma, S)]


def test_float_entry_points_reject_mixed_devices():
    masks = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ConfigError, match="one CUDA device or all on the"):
        bvss_spmm_w(masks, torch.zeros((2, 8, 1), device="meta"))


# ---------------------------------------------------------------------------
# the weight plane and prepare(weights=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(J_FAM))
@pytest.mark.parametrize("sigma", [1, 2, 4, 8, 16, 32])
def test_weight_plane_byte_equal(name, sigma):
    jg, tg = J_FAM[name], T_FAM[name]
    w = dyadic(np.random.default_rng(sigma), jg.m)
    got = build_weight_plane(tg, w, sigma=sigma)
    want = j_build_weight_plane(jg, w, sigma=sigma)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    dev = weight_plane_to_device(got, "cpu")
    assert dev.dtype == torch.float32 and dev.shape[0] == got.shape[0] + 1
    assert torch.isinf(dev[-1]).all()


@pytest.mark.parametrize("order", [True, False])
@pytest.mark.parametrize("name", ["rmat", "grid", "clustered"])
def test_prepare_weights_ride_the_permutation(name, order):
    jg, tg = J_FAM[name], T_FAM[name]
    w = dyadic(np.random.default_rng(5), jg.m)
    jp = repro.prepare(jg, options=repro.PrepareOptions(weights=w,
                                                         order=order))
    tp = repro_torch.prepare(tg, device="cpu", weights=w, order=order)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    assert tp.weights.dtype == np.float32
    np.testing.assert_array_equal(tp.weights, jp.weights)
    np.testing.assert_array_equal(tp.wplane.numpy(), np.asarray(jp.wplane))


def test_prepare_unweighted_has_no_plane_and_bad_weights_raise():
    g = T_FAM["path"]
    p = repro_torch.prepare(g, device="cpu")
    assert p.weights is None and p.wplane is None
    for bad in (np.ones(g.m + 1), -np.ones(g.m), np.zeros(g.m),
                np.full(g.m, np.nan)):
        with pytest.raises(GraphValidationError):
            repro_torch.prepare(g, device="cpu", weights=bad)

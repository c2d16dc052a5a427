"""The port's kernel layer on the CPU against the JAX reference.

Each kernel entry point given CPU tensors runs its PyTorch twin; the twins
must equal the reference's Pallas kernels (run in interpret mode, as
``tests/test_kernels.py`` runs them) exactly: every output is integer or
bool.  The CUDA kernels themselves are held against these twins on the
card by ``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bfs as jbfs
import repro.kernels as jk
import repro_torch.core.bfs as tbfs
import repro_torch.kernels as tk
from repro_torch.errors import ConfigError
from repro_torch.kernels import ref as tref
from torch_one_thread import one_torch_thread  # noqa: F401

SIGMAS = (1, 2, 4, 8, 16, 32)
INF = np.int32(np.iinfo(np.int32).max)


def u32(rng, shape):
    """Random uint32 words with all-ones and bit-31-only words mixed in."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    return w


def t32(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 carrier, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("B", [1, 5, 129, 513])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_pull_twin_equals_pallas(sigma, B):
    rng = np.random.default_rng(sigma * 1000 + B)
    masks, fb = u32(rng, (B, 32)), u32(rng, (B,))
    want = np.asarray(jk.bvss_pull(jnp.asarray(masks), jnp.asarray(fb),
                                   sigma=sigma))
    got = tk.bvss_pull(t32(masks), t32(fb), sigma=sigma)
    assert got.dtype == torch.bool and got.shape == (B, 32 // sigma, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbfs.pull_vss_twin(t32(masks), t32(fb), sigma).numpy(),
        np.asarray(jbfs.pull_vss_jnp(jnp.asarray(masks), jnp.asarray(fb),
                                     sigma)))


@pytest.mark.parametrize("B", [1, 5, 129, 513])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_push_twin_equals_pallas(sigma, B):
    rng = np.random.default_rng(sigma * 1000 + B + 7)
    masks = u32(rng, (B, 32))
    bits = rng.integers(0, sigma, B).astype(np.int32)
    bits[::5] = sigma - 1
    want = np.asarray(jk.bvss_push(jnp.asarray(masks), jnp.asarray(bits),
                                   sigma=sigma))
    got = tk.bvss_push(t32(masks), torch.from_numpy(bits), sigma=sigma)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tk.push_vss_kernel(t32(masks), torch.from_numpy(bits), sigma).numpy(),
        want)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("N", [1, 31, 33, 1000, 2049])
@pytest.mark.parametrize("sigma", [1, 4, 8, 32])
def test_finalize_twin_equals_pallas(sigma, N, lazy):
    rng = np.random.default_rng(sigma * 10_000 + N)
    lvl = 5
    levels = rng.choice(np.array([INF, lvl, 2, 0], np.int32), N,
                        p=[0.5, 0.2, 0.2, 0.1])
    marks = rng.integers(0, 3, N).astype(np.uint8) if lazy else None
    n_sets = -(-N // sigma)
    n_fwords = (n_sets * sigma + 31) // 32
    kw = dict(sigma=sigma, n_fwords=n_fwords, n_sets=n_sets)
    jl, jw, ja = jk.finalize_pack_sweep(
        jnp.asarray(levels), jnp.int32(lvl),
        marks=None if marks is None else jnp.asarray(marks), **kw)
    tl, tw, ta = tk.finalize_pack_sweep(
        torch.from_numpy(levels), lvl,
        marks=None if marks is None else torch.from_numpy(marks), **kw)
    assert tl.dtype == torch.int32 and tw.dtype == torch.int32
    assert ta.dtype == torch.bool
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_finalize_padding_beyond_n():
    """More frontier words and sets than vertices: the padding is never new
    (the reference pads levels with 0)."""
    levels = np.array([3, INF, 3], np.int32)
    kw = dict(sigma=4, n_fwords=3, n_sets=20)
    jl, jw, ja = jk.finalize_pack_sweep(jnp.asarray(levels), jnp.int32(3),
                                        **kw)
    tl, tw, ta = tk.finalize_pack_sweep(torch.from_numpy(levels), 3, **kw)
    np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_level_step_helpers_equal_reference(sigma):
    rng = np.random.default_rng(sigma)
    n_fwords = 9
    F = u32(rng, (n_fwords,))
    n_sets = n_fwords * 32 // sigma
    sets = rng.integers(0, n_sets, 300).astype(np.int32)
    np.testing.assert_array_equal(
        as_u32(tbfs._frontier_bytes(t32(F), torch.from_numpy(sets), sigma)),
        np.asarray(jbfs._frontier_bytes(jnp.asarray(F), jnp.asarray(sets),
                                        sigma)))
    bits = rng.random(n_fwords * 32) < 0.3
    np.testing.assert_array_equal(
        as_u32(tbfs._pack_bits(torch.from_numpy(bits), n_fwords)),
        np.asarray(jbfs._pack_bits(jnp.asarray(bits), n_fwords)))
    popcount = tbfs._make_popcount(torch.device("cpu"))
    assert int(popcount(t32(F))) == int(
        np.unpackbits(F.view(np.uint8)).sum())


@pytest.mark.parametrize("num_vss", [0, 1, 127, 128, 129, 5000, 70_000])
@pytest.mark.parametrize("buckets", [1, 2, 3])
def test_width_ladder_equals_reference(num_vss, buckets):
    widths = tbfs.queue_widths(num_vss, buckets)
    assert widths == jbfs.queue_widths(num_vss, buckets)
    for count in sorted({0, 1, 127, 128, 129, num_vss // 8, num_vss}):
        assert tbfs.selected_width(widths, count) == int(
            jbfs.selected_width(widths, jnp.int32(count)))
        assert tbfs.select_width(widths, count, lambda w: w) == \
            tbfs.selected_width(widths, count)


def test_queue_widths_rejects_zero_buckets():
    with pytest.raises(ConfigError):
        tbfs.queue_widths(100, 0)


def test_dispatch_rule():
    """CPU operands run the twin; mixed or non-CPU/CUDA devices raise."""
    cpu = torch.zeros(2, 32, dtype=torch.int32)
    assert tk.use_kernel(cpu, cpu[:, 0]) is False
    with pytest.raises(ConfigError):
        tk.use_kernel(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ConfigError):
        tk.use_kernel(torch.zeros(2, device="meta"))
    before = tk.launch_counts()
    tk.bvss_pull(cpu, cpu[:, 0].contiguous())
    assert tk.launch_counts() == before     # twin calls are not launches


"""The port's CUDA kernels against their PyTorch twins, and the BFS, wave
and verb entry points against the host oracles, on the card.

These cases need a CUDA card and skip without one: the hand-written
kernels are CUDA C++ with no CPU mode.  The file imports only the port, so
it runs on a machine without JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every output is integer or bool, so kernel and twin must be equal
(closeness, a float64 reduction of equal levels, to rtol 1e-12)."""
import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.kernels as tk
from repro_torch.kernels import ref as tref

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_pull_push_equal_twins(cuda_device, sigma):
    rng = np.random.default_rng(sigma + 100)
    for B in (1, 127, 1003, 4099):
        masks = t32(u32(rng, (B, 32))).to(cuda_device)
        fb = t32(u32(rng, (B,))).to(cuda_device)
        bits = torch.from_numpy(
            rng.integers(0, sigma, B).astype(np.int32)).to(cuda_device)
        before = tk.launch_counts()
        got_pull = tk.bvss_pull(masks, fb, sigma=sigma)
        got_push = tk.bvss_push(masks, bits, sigma=sigma)
        torch.cuda.synchronize()
        after = tk.launch_counts()
        assert after["bvss_pull"] == before["bvss_pull"] + 1
        assert after["bvss_push"] == before["bvss_push"] + 1
        assert torch.equal(got_pull, tref.bvss_pull_ref(masks, fb, sigma))
        assert torch.equal(got_push, tref.bvss_push_ref(masks, bits, sigma))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_spmm_equals_twin(cuda_device, sigma):
    """Ragged B and S (the 16-byte store path at S % 4 == 0, the scalar path
    otherwise), bit-31 words, frontier bytes with bits above σ set."""
    rng = np.random.default_rng(sigma + 200)
    for B in (1, 127, 1003):
        for S in (1, 3, 8, 9, 128):
            masks = t32(u32(rng, (B, 32))).to(cuda_device)
            fb = t32(u32(rng, (B, S))).to(cuda_device)
            before = tk.launch_counts()["bvss_spmm"]
            got = tk.bvss_spmm(masks, fb, sigma=sigma)
            torch.cuda.synchronize()
            assert tk.launch_counts()["bvss_spmm"] == before + 1
            assert torch.equal(got, tref.bvss_spmm_ref(masks, fb, sigma)), \
                (B, S)


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("sigma", [1, 4, 8, 32])
def test_cuda_finalize_equals_twin(cuda_device, sigma, lazy):
    rng = np.random.default_rng(sigma * 3 + lazy)
    lvl = 5
    for N in (1, 33, 1000, 70_001):
        levels = torch.from_numpy(rng.choice(
            np.array([INF, lvl, 2, 0], np.int32), N)).to(cuda_device)
        marks = (torch.from_numpy(rng.integers(0, 3, N).astype(np.uint8))
                 .to(cuda_device) if lazy else None)
        n_sets = -(-N // sigma)
        kw = dict(sigma=sigma, n_fwords=(n_sets * sigma + 31) // 32,
                  n_sets=n_sets, marks=marks)
        got = tk.finalize_pack_sweep(levels, lvl, **kw)
        want = tref.finalize_pack_ref(levels, lvl, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("engine", ["blest", "blest_lazy"])
def test_cuda_bfs_equals_oracle(cuda_device, engine, direction):
    """The entry point on the card, both engines and every direction:
    levels equal to the host oracle, each kernel the step can reach
    launched.  The planted-partition graph in its natural order is the
    setting of tests/test_hybrid.py in which auto mode takes both
    branches."""
    g = repro_torch.generators.clustered(40, 60, p_in=0.4, seed=1)
    tk.reset_launch_counts()
    p = repro_torch.prepare(g, engine=engine, direction=direction,
                            order=False)
    assert p.device.type == "cuda"
    for s in (0, 1111, g.n - 1):
        np.testing.assert_array_equal(p.levels(s),
                                      repro_torch.reference_bfs(g, s))
    counts = tk.launch_counts()
    assert counts["finalize_pack_sweep"] > 0, counts
    assert (counts["bvss_pull"] > 0) == (direction != "push"), counts
    assert (counts["bvss_push"] > 0) == (direction != "pull"), counts


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_cuda_levels_batch_equals_oracle(cuda_device, direction):
    """Wave serving on the card: more queries than slots, a duplicate,
    every direction; each answer equal to the host oracle, every level
    through the bvss_spmm kernel.  On this graph auto takes both branches."""
    g = repro_torch.generators.clustered(40, 60, p_in=0.4, seed=1)
    sess = repro_torch.GraphSession(g, max_batch=4, direction=direction,
                                    order=False)
    queries = [0, 1111, g.n - 1, 7, 1200, 0]
    tk.reset_launch_counts()
    for q, lv in zip(queries, sess.levels_batch(queries)):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, q))
    stats = sess._ms.stats
    levels_run = stats["pull_levels"] + stats["push_levels"]
    assert tk.launch_counts()["bvss_spmm"] == levels_run > 0
    if direction == "auto":
        assert stats["pull_levels"] > 0 and stats["push_levels"] > 0


@pytest.mark.cuda
def test_cuda_wave_verbs_equal_oracles(cuda_device):
    """components, eccentricity_batch and closeness_batch on the card
    against the SciPy oracles, in caller ids."""
    g = repro_torch.generators.rmat(9, 8, seed=1)
    sess = repro_torch.GraphSession(g, max_batch=8)
    srcs = np.random.default_rng(3).integers(0, g.n, 11)
    np.testing.assert_array_equal(sess.components(),
                                  tref.connected_components_ref(g))
    np.testing.assert_array_equal(
        sess.eccentricity_batch(srcs),
        tref.eccentricity_ref(g.symmetrized, srcs))
    np.testing.assert_allclose(sess.closeness_batch(srcs),
                               tref.closeness_ref(g, srcs), rtol=1e-12)

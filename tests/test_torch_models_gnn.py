"""The port's GNN and recsys models (``repro_torch.models.gnn``,
``nequip``, ``dimenet``, ``fm``; ROADMAP.md queue 1 item 13d) against the
JAX reference.

The weights are the reference's ``init_*`` pytrees, carried into the
port by ``load_reference_params``, and the inputs come from numpy seeds,
so both packages compute the same function.  In float32 on the CPU:

* GIN (node task with ``learn_eps`` on and off, graph task), EGNN
  (``mean`` and ``sum`` coordinate aggregation, with and without
  ``graph_ids``), NequIP, DimeNet and FM (``apply_fm`` with and without
  dense features, ``apply_fm_bags``, ``fm_retrieval_scores``,
  ``fm_loss``): outputs within 1e-5 of the largest |output| and each
  leaf's gradient of a seeded cotangent within 1e-4 of its largest
  |gradient|;
* remat equals the plain forward, and its gradients equal the plain
  ones; rotation invariance (and EGNN's equivariance) holds on the port
  at the reference tests' tolerances;
* ``gaunt_tensors`` equal bit for bit, ``real_sph_harm`` within 1e-6;
* ``segment_sum``/``segment_mean`` equal ``jax.ops.segment_sum`` with
  ids -1, ``num`` and ``num + 5`` (values and gradients), and
  ``one_hot`` equals ``jax.nn.one_hot`` out of range;
* ``load_reference_params`` rejects a missing, extra, misshapen or
  mistyped leaf, and the entry points take the card or raise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform as st_rot
import torch

from repro.models import dimenet as JDM
from repro.models import fm as JFM
from repro.models import gnn as JG
from repro.models import nequip as JNQ
from repro_torch.errors import ConfigError
from repro_torch.models import dimenet as TDM
from repro_torch.models import fm as TFM
from repro_torch.models import gnn as TG
from repro_torch.models import nequip as TNQ
from repro_torch.models import transformer as TT
from torch_one_thread import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
N, E = 20, 60
OUT_TOL = 1e-5                   # of the largest |output|
GRAD_TOL = 1e-4                  # of each leaf's largest |gradient|

GIN_CFG = JG.GNNConfig(name="g", n_layers=3, d_hidden=16, d_in=8,
                       n_classes=4)
EGNN_CFG = JG.EGNNConfig(name="e", n_layers=3, d_hidden=16, d_in=8,
                         n_graphs=2)
NEQUIP_CFG = JNQ.NequIPConfig(name="n", n_layers=2, channels=8,
                              n_species=4, n_graphs=2)
DIMENET_CFG = JDM.DimeNetConfig(name="d", n_blocks=2, d_hidden=16,
                                n_species=4, n_graphs=2)
FM_CFG = JFM.FMConfig(name="f", n_fields=10, embed_dim=6,
                      rows_per_field=50, n_dense=3)

PORT_CFG = {JG.GNNConfig: TG.GNNConfig, JG.EGNNConfig: TG.EGNNConfig,
            JNQ.NequIPConfig: TNQ.NequIPConfig,
            JDM.DimeNetConfig: TDM.DimeNetConfig, JFM.FMConfig: TFM.FMConfig}
INITS = {JG.GNNConfig: (JG.init_gin, TG.init_gin),
         JG.EGNNConfig: (JG.init_egnn, TG.init_egnn),
         JNQ.NequIPConfig: (JNQ.init_nequip, TNQ.init_nequip),
         JDM.DimeNetConfig: (JDM.init_dimenet, TDM.init_dimenet),
         JFM.FMConfig: (JFM.init_fm, TFM.init_fm)}


# ---------------------------------------------------------------------------
# inputs and weights
# ---------------------------------------------------------------------------
def port_cfg(cfg):
    return PORT_CFG[type(cfg)](**dataclasses.asdict(cfg))


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_MODELS: dict = {}


def models(cfg):
    """(reference params, the port's model holding the same weights)."""
    if cfg not in _MODELS:
        jinit, tinit = INITS[type(cfg)]
        params = jinit(KEY, cfg)
        model = TT.load_reference_params(
            tinit(port_cfg(cfg), device="cpu"), np_tree(params))
        _MODELS[cfg] = params, model
    return _MODELS[cfg]


def graph(seed: int = 0):
    """N nodes, E random edges and 4 dummy edges; nodes 0..11 in graph
    0, 12..N-1 in graph 1, the dummy row in graph 2."""
    rng = np.random.default_rng(seed)
    senders = np.concatenate([rng.integers(0, N, E),
                              np.full(4, N)]).astype(np.int32)
    receivers = np.concatenate([rng.integers(0, N, E),
                                np.full(4, N)]).astype(np.int32)
    pos = np.zeros((N + 1, 3), np.float32)
    pos[:N] = rng.normal(size=(N, 3))
    feat = np.zeros((N + 1, 8), np.float32)
    feat[:N] = rng.normal(size=(N, 8))
    species = np.concatenate([rng.integers(0, 4, N), [0]]).astype(np.int32)
    gids = np.array([0] * 12 + [1] * (N - 12) + [2], np.int32)
    return dict(senders=senders, receivers=receivers, pos=pos, feat=feat,
                species=species, gids=gids)


def triplets(s, r):
    """The reference test's triplets (k→j, j→i), k != i, at most 100."""
    n_e = len(s)
    trips = [(e1, e2) for e2 in range(n_e) for e1 in range(n_e)
             if s[e2] < N and r[e1] == s[e2] and s[e1] != r[e2]
             and s[e1] < N][:100]
    trips = np.array(trips + [(n_e, n_e)] * 3, np.int32)
    return trips[:, 0], trips[:, 1]


def rotate(pos, seed=1):
    R = st_rot.Rotation.random(random_state=seed).as_matrix().astype(
        np.float32)
    t = np.array([1.0, -2.0, 0.5], np.float32)
    out = pos.copy()
    out[:N] = pos[:N] @ R.T + t
    return out, R, t


# ---------------------------------------------------------------------------
# the cases: (cfg, reference apply, port apply, inputs)
# ---------------------------------------------------------------------------
def _gin(cfg, graph_task=False):
    g = graph(1)
    args = [g["feat"], g["senders"], g["receivers"]]
    if graph_task:
        args.append(g["gids"])
    return cfg, JG.apply_gin, TG.apply_gin, args


def _egnn(coord_agg, with_gids):
    g = graph(2)
    cfg = dataclasses.replace(EGNN_CFG, coord_agg=coord_agg)
    args = [g["feat"], g["pos"], g["senders"], g["receivers"]]
    if with_gids:
        args.append(g["gids"])
    return cfg, JG.apply_egnn, TG.apply_egnn, args


def _nequip(with_gids):
    g = graph(3)
    args = [g["species"], g["pos"], g["senders"], g["receivers"]]
    if with_gids:
        args.append(g["gids"])
    return NEQUIP_CFG, JNQ.apply_nequip, TNQ.apply_nequip, args


def _dimenet(with_gids):
    g = graph(4)
    t_kj, t_ji = triplets(g["senders"], g["receivers"])
    args = [g["species"], g["pos"], g["senders"], g["receivers"], t_kj, t_ji]
    if with_gids:
        args.append(g["gids"])
    return DIMENET_CFG, JDM.apply_dimenet, TDM.apply_dimenet, args


def _fm(kind):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, (16, 10)).astype(np.int32)
    if kind == "apply_fm":
        return FM_CFG, JFM.apply_fm, TFM.apply_fm, [ids]
    if kind == "apply_fm_dense":
        dense = rng.normal(size=(16, 3)).astype(np.float32)
        return FM_CFG, JFM.apply_fm, TFM.apply_fm, [ids, dense]
    if kind == "fm_loss":
        labels = rng.integers(0, 2, 16).astype(np.float32)
        dense = rng.normal(size=(16, 3)).astype(np.float32)
        return FM_CFG, JFM.fm_loss, TFM.fm_loss, [ids, labels, dense]
    if kind == "fm_retrieval_scores":
        cand = rng.integers(0, 50, (40, 5)).astype(np.int32)
        return (FM_CFG, JFM.fm_retrieval_scores, TFM.fm_retrieval_scores,
                [ids[0, :4], cand])
    # apply_fm_bags: 3 ids a bag for 8 examples of 10 fields, dummies
    rows = rng.integers(0, FM_CFG.total_rows, 240).astype(np.int32)
    bags = np.repeat(np.arange(80, dtype=np.int32), 3)
    bags[::7] = 80                                     # dummy entries
    return FM_CFG, JFM.apply_fm_bags, TFM.apply_fm_bags, [rows, bags, 80]


CASES = {
    "gin_node_eps": lambda: _gin(GIN_CFG),
    "gin_node_fixed_eps": lambda: _gin(
        dataclasses.replace(GIN_CFG, learn_eps=False)),
    "gin_graph": lambda: _gin(
        dataclasses.replace(GIN_CFG, task="graph", n_graphs=2), True),
    "egnn_mean": lambda: _egnn("mean", True),
    "egnn_sum": lambda: _egnn("sum", True),
    "egnn_mean_total": lambda: _egnn("mean", False),
    "nequip": lambda: _nequip(True),
    "nequip_total": lambda: _nequip(False),
    "dimenet": lambda: _dimenet(True),
    "dimenet_total": lambda: _dimenet(False),
    "apply_fm": lambda: _fm("apply_fm"),
    "apply_fm_dense": lambda: _fm("apply_fm_dense"),
    "apply_fm_bags": lambda: _fm("apply_fm_bags"),
    "fm_retrieval_scores": lambda: _fm("fm_retrieval_scores"),
    "fm_loss": lambda: _fm("fm_loss"),
}
GNN_CASES = [k for k in CASES if not k.startswith(("apply_fm", "fm_"))]
_JITTED: dict = {}


def jit_of(fn):
    """The reference's function, compiled once a config."""
    if fn not in _JITTED:
        _JITTED[fn] = jax.jit(fn, static_argnums=(1,))
    return _JITTED[fn]


def j_args(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]


def t_args(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def outputs(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def cotangents(outs, seed: int = 9) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]


def reference_run(name):
    """(outputs, gradients by leaf path) of the reference: the gradient of
    Σ cotangent · output."""
    cfg, jfn, _, args = CASES[name]()
    params, _ = models(cfg)
    if jfn is JFM.apply_fm_bags:
        fn = jax.jit(lambda p, *a: jfn(p, cfg, *a[:-1], args[-1]))
        call_args = j_args(args[:-1]) + [args[-1]]
    else:
        fn = lambda p, *a: jit_of(jfn)(p, cfg, *a)
        call_args = j_args(args)
    outs = [np.asarray(o) for o in outputs(fn(params, *call_args))]
    cots = cotangents(outs)

    def scalar(p):
        return sum(jnp.sum(o * c) for o, c in
                   zip(outputs(fn(p, *call_args)), cots))

    grads = TT.reference_paths(np_tree(jax.grad(scalar)(params)))
    return outs, cots, grads


def port_run(name, remat=None):
    cfg, _, tfn, args = CASES[name]()
    _, model = models(cfg)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in TT.reference_leaves(model).items()}
    kw = {} if remat is None else {"remat": remat}
    outs = outputs(tfn(TT.bind(model, leaves), port_cfg(cfg),
                       *t_args(args), **kw))
    return outs, leaves


def port_grads(outs, leaves, cots) -> dict:
    scalar = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(scalar, list(leaves.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def close_to_max(got: np.ndarray, want: np.ndarray, frac: float, what: str):
    bound = frac * float(np.abs(want).max(initial=0.0))
    err = float(np.abs(got - want).max(initial=0.0))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= bound, (what, err, bound)


# ---------------------------------------------------------------------------
# every model and entry point against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_and_gradients_equal_reference(name):
    want, cots, want_g = reference_run(name)
    outs, leaves = port_run(name)
    for i, (o, w) in enumerate(zip(outs, want)):
        close_to_max(o.detach().numpy(), w, OUT_TOL, f"output {i}")
    got_g = port_grads(outs, leaves, cots)
    assert set(got_g) == set(want_g)
    for k, g in got_g.items():
        close_to_max(g.numpy(), np.asarray(want_g[k]), GRAD_TOL, k)


@pytest.mark.parametrize("name", GNN_CASES)
def test_remat_equals_plain(name):
    plain, leaves_p = port_run(name, remat=False)
    remat, leaves_r = port_run(name, remat=True)
    cots = cotangents([o.detach().numpy() for o in plain])
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    gp = port_grads(plain, leaves_p, cots)
    gr = port_grads(remat, leaves_r, cots)
    for k in gp:
        torch.testing.assert_close(gr[k], gp[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


# ---------------------------------------------------------------------------
# the reference tests' properties on the port
# ---------------------------------------------------------------------------
def test_egnn_equivariance():
    cfg, _, tfn, args = _egnn("mean", True)
    _, model = models(cfg)
    feat, pos, s, r, gids = args
    with torch.no_grad():
        e1, x1 = tfn(model, port_cfg(cfg), *t_args([feat, pos, s, r, gids]))
        pos2, R, t = rotate(pos)
        e2, x2 = tfn(model, port_cfg(cfg), *t_args([feat, pos2, s, r, gids]))
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(x2.numpy()[:N], x1.numpy()[:N] @ R.T + t,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["nequip", "dimenet"])
def test_rotation_invariance(name):
    cfg, _, tfn, args = CASES[name]()
    _, model = models(cfg)
    pos_i = 1
    with torch.no_grad():
        e1 = tfn(model, port_cfg(cfg), *t_args(args))
        args2 = list(args)
        args2[pos_i], _, _ = rotate(args[pos_i])
        e2 = tfn(model, port_cfg(cfg), *t_args(args2))
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-3, atol=1e-5)


def test_gaunt_tensors_and_sph_harm_equal_reference():
    want = JNQ.gaunt_tensors()
    got = TNQ.gaunt_tensors()
    assert sorted(got) == sorted(want) == TNQ.paths() == JNQ.paths()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[(0, 0, 0)][0, 0, 0], 0.28209479,
                               rtol=1e-5)
    _, model = models(NEQUIP_CFG)
    for k in want:            # the model's buffers: float32, made once
        np.testing.assert_array_equal(model.gaunt(k).numpy(),
                                      want[k].astype(np.float32))
    rng = np.random.default_rng(6)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for a, b in zip(TNQ.real_sph_harm(torch.from_numpy(v)),
                    JNQ.real_sph_harm(jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    r = np.linspace(0.0, 6.0, 50).astype(np.float32)
    np.testing.assert_allclose(
        TNQ.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(JNQ.bessel_rbf(jnp.asarray(r), 8, 5.0)), rtol=1e-5,
        atol=1e-5)
    c = np.linspace(-1.0, 1.0, 33).astype(np.float32)
    np.testing.assert_allclose(
        TDM.legendre_basis(torch.from_numpy(c), 7).numpy(),
        np.asarray(JDM.legendre_basis(jnp.asarray(c), 7)), rtol=0,
        atol=1e-6)


# ---------------------------------------------------------------------------
# JAX's out-of-range semantics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [None, 3])
def test_segment_sum_and_mean_drop_out_of_range_ids(width):
    num = 6
    rng = np.random.default_rng(7)
    ids = np.array([0, 1, 5, -1, num, num + 5, 2, 2, 5, -3, 4, 0], np.int32)
    shape = (len(ids),) if width is None else (len(ids), width)
    vals = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), num))
    want_m = np.asarray(JG.segment_mean(jnp.asarray(vals), jnp.asarray(ids),
                                        num))
    t = torch.from_numpy(vals).requires_grad_(True)
    got = TG.segment_sum(t, torch.from_numpy(ids), num)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(
        TG.segment_mean(t, torch.from_numpy(ids), num).detach().numpy(),
        want_m, rtol=1e-6)
    cot = rng.normal(size=want.shape).astype(np.float32)
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), t)
    jg = jax.grad(lambda v: jnp.sum(jax.ops.segment_sum(
        v, jnp.asarray(ids), num) * cot))(jnp.asarray(vals))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    # the documented example: [0, 1, 5, -1] into 2 segments
    assert TG.segment_sum(torch.tensor([0., 1., 2., 3.]),
                          torch.tensor([0, 1, 5, -1]), 2).tolist() == [0., 1.]


def test_one_hot_is_zero_out_of_range():
    ids = np.array([[0, 3, -1], [4, 7, 2]], np.int32)
    for n in (1, 4, 8):
        want = np.asarray(jax.nn.one_hot(jnp.asarray(ids), n))
        got = TG.one_hot(torch.from_numpy(ids), n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert TG.one_hot(torch.tensor([5, -2]), 3).abs().sum() == 0


# ---------------------------------------------------------------------------
# loading and devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
@pytest.mark.parametrize("cfg", [GIN_CFG, NEQUIP_CFG, FM_CFG],
                         ids=["gin", "nequip", "fm"])
def test_load_reference_params_rejects_mismatch(cfg, fault):
    params, _ = models(cfg)
    tree = np_tree(params)
    if fault == "missing":
        del tree["head" if "head" in tree else "w"]
    elif fault == "extra":
        tree["bias_extra"] = np.zeros(3, np.float32)
    elif fault == "shape":
        leaf = tree["layers"][0] if "layers" in tree else tree
        key = "eps" if "eps" in leaf else ("gate" if "gate" in leaf else "b")
        leaf[key] = np.zeros(np.shape(leaf[key]) + (1,), np.float32)
    else:
        key = next(k for k in ("embed", "v", "head") if k in tree)
        tree[key] = tree[key].astype(np.float64)
    _, tinit = INITS[type(cfg)]
    with pytest.raises(ConfigError):
        TT.load_reference_params(tinit(port_cfg(cfg), device="cpu"), tree)


def test_init_is_seeded_and_takes_the_card_or_raises(monkeypatch):
    """The same seed gives the same weights; with no device the models go
    on the card, and with no card that is a ``ConfigError``; a generator
    on another device than the model's is refused."""
    for cfg in (GIN_CFG, EGNN_CFG, NEQUIP_CFG, DIMENET_CFG, FM_CFG):
        _, tinit = INITS[type(cfg)]
        a = tinit(port_cfg(cfg), torch.Generator().manual_seed(3),
                  device="cpu")
        b = tinit(port_cfg(cfg), torch.Generator().manual_seed(3),
                  device="cpu")
        for (name, pa), (_, pb) in zip(a.named_parameters(),
                                       b.named_parameters()):
            assert torch.equal(pa, pb), name
        assert set(TT.reference_paths(np_tree(models(cfg)[0]))) == \
            set(TT.reference_leaves(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    classes = (TG.GIN, TG.EGNN, TNQ.NequIP, TDM.DimeNet, TFM.FM)
    for cfg, cls in zip((GIN_CFG, EGNN_CFG, NEQUIP_CFG, DIMENET_CFG, FM_CFG),
                        classes):
        _, tinit = INITS[type(cfg)]
        for build in (lambda: tinit(port_cfg(cfg)),
                      lambda: tinit(port_cfg(cfg), torch.Generator()),
                      lambda: cls(port_cfg(cfg), torch.Generator())):
            with pytest.raises(ConfigError, match="no CUDA device"):
                build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ConfigError, match="generator is on cpu"):
        TG.init_gin(port_cfg(GIN_CFG), torch.Generator())

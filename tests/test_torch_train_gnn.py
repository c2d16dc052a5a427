"""Training the port's GNN and recsys models (``repro_torch.launch.train``'s
``gnn_setup`` and ``rec_setup``, ``repro_torch.configs.families``;
ROADMAP.md queue 1 item 13d) against the JAX reference.

The parameters are the reference's ``init_*`` pytrees, carried into the
port as ``{path: tensor}`` leaves; each side trains on its own
launcher's batches (the same builders, the same seeds).  In float32 on
the CPU:

* 6 AdamW steps of ``train()`` for GIN (its full-graph batch), EGNN,
  NequIP and DimeNet (molecule batches made anew each step) and FM give
  the reference's losses within 1e-4;
* the launcher trains all five archs' smoke configs with ``--device
  cpu``, every loss finite;
* a GNN training restart from its checkpoint is bit-exact;
* the reference's ``n_graphs = 1`` readout over a launcher's molecule
  batch of 8 graphs, kept by the port: the energy has one entry, graph
  0's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.data.graphs import molecule_batch as jmolecule_batch
from repro.launch import train as jlaunch
from repro.models import gnn as JG
from repro.train import TrainConfig as JTrainConfig
from repro.train import train as jtrain
from repro_torch.configs import get_arch
from repro_torch.data import molecule_batch
from repro_torch.ft import FailureInjector, RestartManager, list_checkpoints
from repro_torch.launch import train as tlaunch
from repro_torch.models import gnn as TG
from repro_torch.models import transformer as TT
from repro_torch.train import TrainConfig, train
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = ["gin-tu", "egnn", "nequip", "dimenet", "fm"]
ARGS = argparse.Namespace(seed=0, batch=8)


def quiet(_msg):
    pass


def leaves_of(tree) -> dict:
    """A reference pytree as the port's ``{path: tensor}`` leaves."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            TT.reference_paths(jax.tree_util.tree_map(np.asarray,
                                                      tree)).items()}


def setups(arch_id: str):
    """The reference's and the port's (params, loss_fn, batch_fn) of the
    launcher for ``arch_id``'s smoke config, the port's params replaced
    by the reference's."""
    jarch, arch = jget_arch(arch_id), get_arch(arch_id)
    if arch.family == "gnn":
        want = jlaunch.gnn_setup(jarch, jarch.smoke_cfg, ARGS)
        got = tlaunch.gnn_setup(arch, arch.smoke_cfg, ARGS, "cpu")
    else:
        want = jlaunch.rec_setup(jarch, jarch.smoke_cfg, ARGS)
        got = tlaunch.rec_setup(arch.smoke_cfg, ARGS, "cpu")
    params = leaves_of(want[0])
    assert {k: v.shape for k, v in params.items()} == \
        {k: v.shape for k, v in got[0].items()}
    return want, (params, *got[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_losses_equal_reference(arch):
    """6 AdamW steps (warm-up and cosine): every step's loss within 1e-4
    of the reference's."""
    (jp, jloss, jbatch), (tp, tloss, tbatch) = setups(arch)
    kw = dict(steps=6, log_every=1, peak_lr=1e-2, warmup=2)
    want = jtrain(jloss, jp, jbatch, JTrainConfig(**kw), log_fn=quiet).losses
    got = train(tloss, tp, tbatch, TrainConfig(**kw), log_fn=quiet).losses
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 7))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-4)


def run_main(main, argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().strip().splitlines()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_gnn_and_recsys_on_cpu(arch):
    lines = run_main(tlaunch.main, ["--arch", arch, "--steps", "8",
                                    "--device", "cpu"])
    family = get_arch(arch).family
    assert lines[0].startswith(f"[train] arch={arch} family={family} "
                               f"params=")
    losses = [float(x) for x in
              lines[-1].split("loss ")[1].split(" (")[0].split(" -> ")]
    assert np.isfinite(losses).all()
    assert "straggler timeouts: 0" in lines[-1]


def test_gnn_restart_bit_exact():
    """DimeNet on molecule batches made anew each step: a failure at step
    6 and the restart from the step-4 checkpoint end with the
    uninterrupted run's parameters, bit for bit."""
    _, (params, loss_fn, batch_fn) = setups("dimenet")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t1 = TrainConfig(steps=8, log_every=4, ckpt_every=4, ckpt_dir=d1,
                         peak_lr=1e-2, warmup=2)
        r1 = train(loss_fn, params, batch_fn, t1, log_fn=quiet)
        t2 = dataclasses.replace(t1, ckpt_dir=d2)
        inj = FailureInjector(fail_at_steps=(6,))
        mgr = RestartManager(max_restarts=2)
        r2 = mgr.run(lambda resume: train(loss_fn, params, batch_fn, t2,
                                          injector=inj, log_fn=quiet))
        assert mgr.stats.restarts == 1
        assert [s for s, _ in list_checkpoints(d2)] == [4, 8]
    for k, a in r1.final_state.params.items():
        assert torch.equal(a, r2.final_state.params[k]), k
    assert r1.losses[-1] == r2.losses[-1]


def test_molecule_readout_keeps_graph_zero_alone():
    """The launcher's molecule batches number their graphs 0 .. B-1, but
    the configs read ``n_graphs = 1`` energies: the readout keeps graph 0
    alone, in the reference and in the port (kept for parity; PERF.md
    §7).  Read with ``n_graphs = B``, every graph's energy comes out and
    the first equals it."""
    jarch = jget_arch("egnn")
    cfg = jarch.smoke_cfg
    assert cfg.n_graphs == 1
    want_p = setups("egnn")[0][0]
    mb, jmb = molecule_batch(8, 12, 32, seed=0), jmolecule_batch(8, 12, 32,
                                                                 seed=0)
    feat = np.asarray(jax.nn.one_hot(jmb.species % cfg.d_in, cfg.d_in))
    jargs = [jnp.asarray(a) for a in (feat, jmb.pos, jmb.senders,
                                      jmb.receivers, jmb.graph_ids)]
    model = TT.load_reference_params(
        TG.init_egnn(TG.EGNNConfig(**dataclasses.asdict(cfg)), device="cpu"),
        jax.tree_util.tree_map(np.asarray, want_p))
    targs = [torch.from_numpy(a) for a in (mb.pos, mb.senders, mb.receivers,
                                           mb.graph_ids)]
    tfeat = TG.one_hot(torch.from_numpy(mb.species) % cfg.d_in, cfg.d_in)
    np.testing.assert_array_equal(tfeat.numpy(), feat)
    energies = []
    for n_graphs in (1, 8):
        jcfg = dataclasses.replace(cfg, n_graphs=n_graphs)
        want, _ = JG.apply_egnn(want_p, jcfg, *jargs)
        with torch.no_grad():
            got, _ = TG.apply_egnn(model, TG.EGNNConfig(
                **dataclasses.asdict(jcfg)), tfeat, *targs)
        assert got.shape == want.shape == (n_graphs,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        energies.append(got)
    torch.testing.assert_close(energies[0][0], energies[1][0], rtol=1e-6,
                               atol=1e-6)

"""DimeNet-lite [arXiv:2003.03123], the port of ``repro/models/dimenet.py``:
directional message passing over triplets of edges.

Config (assigned): n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6.  The radial basis is the paper's Bessel basis; the 2-D
spherical basis is simplified to (Bessel radial) × (Legendre P_l of the
triplet angle), the reference's documented simplification.  The
interaction block follows the DimeNet++ bilinear form with
``n_bilinear`` as the down-projected interaction width.

Inputs are batched molecular graphs with triplet index lists from the
data pipeline (``repro_torch.data.graphs.molecule_batch``): for each
pair of incident edges (k→j, j→i) one triplet with edge ids (e_kj, e_ji).
As in the reference, the edge arrays get a padded dummy edge row E (its
length 1, its radial basis and message zero), ``cos_t`` is clipped to
[-1, 1], the norms carry the ``1e-12`` guards, and the triplet messages
sum into E + 1 segments of which the dummy's is cut.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import flatten_axes
from repro_torch.models.gnn import (MLP2, _live_rows, _remat, edgewise,
                                    gather_rows, mlp2_apply, mlp2_axes,
                                    one_hot, segment_sum)
from repro_torch.models.layers import dense_init
from repro_torch.models.nequip import bessel_rbf
from repro_torch.models.transformer import (float32_matmuls,
                                            init_generator, model_device)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 8
    n_graphs: int = 1


def legendre_basis(cos_t: torch.Tensor, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cos θ) via the recurrence (T,) -> (T, n)."""
    outs = [torch.ones_like(cos_t), cos_t]
    for l in range(2, n):
        outs.append(((2 * l - 1) * cos_t * outs[-1]
                     - (l - 1) * outs[-2]) / l)
    return torch.stack(outs[:n], dim=-1)


class DimeNetBlock(nn.Module):
    def __init__(self, cfg: DimeNetConfig, generator, device):
        super().__init__()
        d, nb = cfg.d_hidden, cfg.n_bilinear
        self.w_self = nn.Parameter(dense_init(generator, (d, d), d, device))
        self.w_down = nn.Parameter(dense_init(generator, (d, nb), d, device))
        self.w_sbf = nn.Parameter(dense_init(
            generator, (cfg.n_spherical * cfg.n_radial, nb), cfg.n_spherical,
            device))
        self.w_up = nn.Parameter(dense_init(generator, (nb, d), nb, device))
        self.rbf_gate = nn.Parameter(dense_init(
            generator, (cfg.n_radial, d), cfg.n_radial, device))
        self.out = MLP2(d, d, d, generator, device)


class DimeNet(nn.Module):
    """``init_dimenet``'s tree: ``embed``, ``rbf_proj``, the ``msg_init``
    and ``out_head`` MLPs and ``blocks``."""

    def __init__(self, cfg: DimeNetConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.n_species, d), cfg.n_species, device))
        self.rbf_proj = nn.Parameter(dense_init(
            generator, (cfg.n_radial, d), cfg.n_radial, device))
        self.msg_init = MLP2(3 * d, d, d, generator, device)
        self.out_head = MLP2(d, d, 1, generator, device)
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, generator, device)
                                    for _ in range(cfg.n_blocks))


def dimenet_axes(cfg: DimeNetConfig) -> dict[str, tuple]:
    """DimeNet's logical axes (the reference's ``dimenet_axes``)."""
    return flatten_axes({
        "embed": (None, "ffn"), "rbf_proj": (None, "ffn"),
        "msg_init": mlp2_axes(),
        "blocks": [{"w_self": (None, None), "w_down": (None, None),
                    "w_sbf": (None, None), "w_up": (None, None),
                    "rbf_gate": (None, None), "out": mlp2_axes()}
                   for _ in range(cfg.n_blocks)],
        "out_head": mlp2_axes()})


def init_dimenet(cfg: DimeNetConfig, generator: torch.Generator | None = None,
                 device=None) -> DimeNet:
    return DimeNet(cfg, *init_generator(generator, device))


def apply_dimenet(p: DimeNet, cfg: DimeNetConfig, species, pos, senders,
                  receivers, t_kj, t_ji, graph_ids=None,
                  remat: bool = False) -> torch.Tensor:
    """species (N+1,), pos (N+1, 3); edges k→j as (senders, receivers)
    (E,) padded with dummy node N; triplets as edge-id pairs (t_kj, t_ji)
    (T,) padded with dummy edge E (an extra zero edge row is appended).
    Returns per-graph energies (G,) (the total, a 0-d tensor, without
    ``graph_ids``)."""
    n1 = species.shape[0]
    E = senders.shape[0]
    dt, dev = pos.dtype, pos.device
    remat = remat and torch.is_grad_enabled()
    live_e = ((senders < n1 - 1) & (receivers < n1 - 1)).to(dt)[:, None]

    with float32_matmuls(dt):
        d_vec = gather_rows(pos, senders) - gather_rows(pos, receivers)
        r = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1) + 1e-12)
        rbf = bessel_rbf(r, cfg.n_radial, cfg.cutoff) * live_e  # (E, n_rad)

        h = one_hot(species, cfg.n_species, dt) @ p.embed.to(dt)
        e_rbf = rbf @ p.rbf_proj.to(dt)
        m = mlp2_apply(p.msg_init,
                       torch.cat([gather_rows(h, senders),
                                  gather_rows(h, receivers), e_rbf], -1))
        m = m * live_e                                         # (E, d)

        # triplet angle basis: angle between edge (k→j) and (j→i) at j
        dv = torch.cat([d_vec, torch.zeros((1, 3), dtype=dt, device=dev)])
        rr = torch.cat([r, torch.ones((1,), dtype=dt, device=dev)])
        rbf_pad = torch.cat([rbf, torch.zeros((1, cfg.n_radial), dtype=dt,
                                              device=dev)])

        def basis(v1, v2, r1, r2, rb):
            cos_t = torch.sum(v1 * v2, -1) / (r1 * r2 + 1e-12)
            cos_t = torch.clamp(cos_t, -1.0, 1.0)
            ang = legendre_basis(cos_t, cfg.n_spherical)       # (T, n_sph)
            return (ang[:, :, None] * rb[:, None, :]).reshape(
                rb.shape[0], -1)                               # (T, nsph*nrad)
        sbf = edgewise(basis, rows=(
            gather_rows(dv, t_kj), -gather_rows(dv, t_ji),
            gather_rows(rr, t_kj), gather_rows(rr, t_ji),
            gather_rows(rbf_pad, t_kj)))
        t_live = ((t_kj < E) & (t_ji < E)).to(dt)[:, None]
        sbf = sbf * t_live

        def block(m, energy, bp):
            m_pad = torch.cat([m, m.new_zeros((1, cfg.d_hidden))])
            t1 = gather_rows(m_pad, t_kj) @ bp.w_down.to(dt)   # (T, nb)
            t2 = sbf @ bp.w_sbf.to(dt)                         # (T, nb)
            agg = segment_sum(t1 * t2 * t_live, t_ji, E + 1)[:E]
            m = F.silu(m @ bp.w_self.to(dt) + agg @ bp.w_up.to(dt)
                       + rbf @ bp.rbf_gate.to(dt)) * live_e
            node_m = segment_sum(mlp2_apply(bp.out, m) * live_e, receivers,
                                 n1)
            energy = energy + mlp2_apply(p.out_head, node_m)[:, 0]
            return m, energy

        energy = torch.zeros((n1,), dtype=dt, device=dev)
        for bp in p.blocks:
            m, energy = _remat(block, m, energy, bp) if remat \
                else block(m, energy, bp)

    energy = energy * _live_rows(n1, dt, dev)[:, 0]
    if graph_ids is None:
        return energy.sum()
    return segment_sum(energy, graph_ids, cfg.n_graphs + 1)[:-1]

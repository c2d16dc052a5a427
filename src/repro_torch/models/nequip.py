"""NequIP-lite [arXiv:2101.03164], the port of ``repro/models/nequip.py``:
an O(3)-equivariant interatomic potential with l_max = 2, written without
e3nn.

Features are irrep channels {l: (N+1, C, 2l+1)} for l = 0, 1, 2.
Messages couple neighbour features with the real spherical harmonics of
the edge direction through Gaunt coupling tensors

    C3[l1][l2][l3][m1, m2, m3] = ∫ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3} dΩ,

integrated numerically once on the host (Gauss-Legendre × uniform-φ
quadrature, numpy, copied from the reference so that the tensors are
equal bit for bit).  A :class:`NequIP` model holds them as buffers on its
device, made once, where the reference copies them from the host on
every call.  Radial dependence enters through per-path weights from an
MLP over a Bessel radial basis with a polynomial envelope.
"""
from __future__ import annotations

import dataclasses
import itertools
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import flatten_axes
from repro_torch.models.gnn import (MLP2, _live_rows, _remat, edgewise,
                                    gather_rows, mlp2_apply, mlp2_axes,
                                    one_hot, segment_sum)
from repro_torch.models.layers import dense_init
from repro_torch.models.transformer import (float32_matmuls,
                                            init_generator, model_device)

L_MAX = 2


# ---------------------------------------------------------------------------
# real spherical harmonics (l <= 2), (…, 3) -> list of (…, 2l+1)
# ---------------------------------------------------------------------------
def real_sph_harm(r_hat: torch.Tensor) -> list[torch.Tensor]:
    x, y, z = r_hat[..., 0], r_hat[..., 1], r_hat[..., 2]
    y0 = 0.28209479177387814 * torch.ones_like(x)
    y1 = 0.4886025119029199 * torch.stack([y, z, x], dim=-1)
    y2 = torch.stack([
        1.0925484305920792 * x * y,
        1.0925484305920792 * y * z,
        0.31539156525252005 * (3.0 * z * z - 1.0),
        1.0925484305920792 * x * z,
        0.5462742152960396 * (x * x - y * y),
    ], dim=-1)
    return [y0[..., None], y1, y2]


def _real_sph_harm_np(x, y, z):
    y0 = 0.28209479177387814 * np.ones_like(x)
    y1 = 0.4886025119029199 * np.stack([y, z, x], axis=-1)
    y2 = np.stack([
        1.0925484305920792 * x * y,
        1.0925484305920792 * y * z,
        0.31539156525252005 * (3.0 * z * z - 1.0),
        1.0925484305920792 * x * z,
        0.5462742152960396 * (x * x - y * y),
    ], axis=-1)
    return [y0[..., None], y1, y2]


@lru_cache(maxsize=1)
def gaunt_tensors() -> dict[tuple[int, int, int], np.ndarray]:
    """Numerically integrated Gaunt tensors for all l1, l2, l3 <= 2."""
    nt, nphi = 64, 128
    t, wt = np.polynomial.legendre.leggauss(nt)   # cos(theta) nodes
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    wphi = 2 * np.pi / nphi
    ct = t[:, None] * np.ones(nphi)[None, :]
    st = np.sqrt(1 - ct ** 2)
    x = st * np.cos(phi)[None, :]
    y = st * np.sin(phi)[None, :]
    z = ct
    Y = _real_sph_harm_np(x, y, z)                # [(nt, nphi, 2l+1)] l<=2
    w = wt[:, None] * wphi                         # (nt, nphi)
    out = {}
    for l1, l2, l3 in itertools.product(range(L_MAX + 1), repeat=3):
        if (l1 + l2 + l3) % 2 != 0:
            continue                               # parity-forbidden
        if l3 < abs(l1 - l2) or l3 > l1 + l2:
            continue                               # triangle inequality
        c = np.einsum("tp,tpa,tpb,tpc->abc", w, Y[l1], Y[l2], Y[l3])
        if np.abs(c).max() > 1e-10:
            out[(l1, l2, l3)] = c
    return out


def paths():
    return sorted(gaunt_tensors().keys())


# ---------------------------------------------------------------------------
# config + params
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    n_graphs: int = 1


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel basis sin(n π r / c) / r with polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = float(np.sqrt(np.float32(2.0 / cutoff))) * torch.sin(
        n * np.pi * r[..., None] / cutoff) / r[..., None]
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5
    return basis * env[..., None]


class NequIPLayer(nn.Module):
    def __init__(self, cfg: NequIPConfig, n_paths: int, generator, device):
        super().__init__()
        C = cfg.channels
        self.radial = MLP2(cfg.n_rbf, C, n_paths * C, generator, device)
        self.self = nn.ParameterDict({
            f"l{l}": nn.Parameter(dense_init(generator, (C, C), C, device))
            for l in range(L_MAX + 1)})
        self.gate = nn.Parameter(dense_init(generator, (C, (L_MAX + 1) * C),
                                            C, device))


class NequIP(nn.Module):
    """``init_nequip``'s tree: ``embed`` (n_species, C), ``layers``
    (``radial``, ``self`` by l, ``gate``) and the ``head`` MLP; the Gaunt
    tensors of :func:`paths` as float32 buffers ``gaunt_<l1><l2><l3>``."""

    def __init__(self, cfg: NequIPConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        P = paths()
        C = cfg.channels
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.n_species, C), cfg.n_species, device))
        self.layers = nn.ModuleList(NequIPLayer(cfg, len(P), generator,
                                                device)
                                    for _ in range(cfg.n_layers))
        self.head = MLP2(C, C, 1, generator, device)
        for key, c in gaunt_tensors().items():
            self.register_buffer(
                "gaunt_" + "".join(map(str, key)),
                torch.from_numpy(c.astype(np.float32)).to(device),
                persistent=False)

    def gaunt(self, key: tuple[int, int, int]) -> torch.Tensor:
        return getattr(self, "gaunt_" + "".join(map(str, key)))


def nequip_axes(cfg: NequIPConfig) -> dict[str, tuple]:
    """NequIP's logical axes (the reference's ``nequip_axes``)."""
    return flatten_axes({"embed": (None, "ffn"),
                         "layers": [{"radial": mlp2_axes(),
                                     "self": {f"l{l}": (None, None)
                                              for l in range(L_MAX + 1)},
                                     "gate": (None, None)}
                                    for _ in range(cfg.n_layers)],
                         "head": mlp2_axes()})


def init_nequip(cfg: NequIPConfig, generator: torch.Generator | None = None,
                device=None) -> NequIP:
    return NequIP(cfg, *init_generator(generator, device))


def apply_nequip(p: NequIP, cfg: NequIPConfig, species, pos, senders,
                 receivers, graph_ids=None, remat: bool = False
                 ) -> torch.Tensor:
    """species (N+1,) int (dummy = 0 with zero mask), pos (N+1, 3).
    Returns per-graph energies (G,) (or the total, a 0-d tensor, if
    ``graph_ids`` is None)."""
    n1 = species.shape[0]
    C = cfg.channels
    dt = pos.dtype
    remat = remat and torch.is_grad_enabled()
    live = _live_rows(n1, dt, pos.device)
    P = paths()
    gt = {k: p.gaunt(k).to(dt) for k in P}

    def layer(f0, f1, f2, lp):
        feats = {0: f0, 1: f1, 2: f2}
        Rw = mlp2_apply(lp.radial, rbf).reshape(-1, len(P), C)  # (E, P, C)
        msg = {l: None for l in range(L_MAX + 1)}
        for pi, (l1, l2, l3) in enumerate(P):
            f_j = gather_rows(feats[l1], senders)           # (E, C, 2l1+1)
            # (E,C,a) x (E,b) x (a,b,k) -> (E,C,k), radially weighted
            t = edgewise(lambda f, y, rw, g, pi=pi: torch.einsum(
                "eca,eb,abk->eck", f, y, g) * rw[:, pi, :, None],
                rows=(f_j, Y[l2], Rw), consts=(gt[(l1, l2, l3)],))
            msg[l3] = t if msg[l3] is None else msg[l3] + t
        new_feats = {}
        for l in range(L_MAX + 1):
            agg = segment_sum(msg[l], receivers, n1) \
                if msg[l] is not None else torch.zeros_like(feats[l])
            mixed = torch.einsum("ncm,ck->nkm", agg,
                                 lp.self[f"l{l}"].to(dt))
            new_feats[l] = feats[l] + mixed
        # gated nonlinearity: scalars gate all l-channels
        gates = (new_feats[0][:, :, 0] @ lp.gate.to(dt)
                 ).reshape(n1, L_MAX + 1, C)
        return tuple((new_feats[l] * F.silu(gates[:, l, :])[:, :, None])
                     * live[:, :, None] for l in range(L_MAX + 1))

    with float32_matmuls(dt):
        # initial features: scalars from species embedding; higher l at 0
        h0 = one_hot(species, cfg.n_species, dt) @ p.embed.to(dt)
        feats = ((h0 * live)[:, :, None],
                 torch.zeros((n1, C, 3), dtype=dt, device=pos.device),
                 torch.zeros((n1, C, 5), dtype=dt, device=pos.device))
        d_vec = gather_rows(pos, senders) - gather_rows(pos, receivers)

        def geometry(d_vec):
            r = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1) + 1e-12)
            r_hat = d_vec / r[:, None]
            # [(E, 2l+1)] and the (E, n_rbf) radial basis
            return (*real_sph_harm(r_hat), bessel_rbf(r, cfg.n_rbf,
                                                      cfg.cutoff))
        *Y, rbf = edgewise(geometry, rows=(d_vec,))
        for lp in p.layers:
            feats = _remat(layer, *feats, lp) if remat else layer(*feats, lp)
        node_e = mlp2_apply(p.head, feats[0][:, :, 0])[:, 0] * live[:, 0]
    if graph_ids is None:
        return node_e.sum()
    return segment_sum(node_e, graph_ids, cfg.n_graphs + 1)[:-1]

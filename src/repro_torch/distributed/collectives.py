"""Frontier collectives of the mesh-native engines (DESIGN §3), the port
of the butterfly half of ``repro/distributed/collectives.py``.

* **Butterfly frontier collectives** (the 2-D partition): staged
  recursive-doubling exchanges.  ``butterfly_frontier_exchange``
  all-gathers per-rank frontier word segments along a mesh axis in index
  order (stage ``s`` pairs rank ``d`` with ``d ^ (1 << s)``, doubling the
  held block each stage); ``butterfly_or_allreduce`` OR-combines partial
  hit words via recursive-halving reduce-scatter + recursive-doubling
  all-gather.  Each of the reference's ``ppermute`` stages is one pairwise
  exchange here (:func:`_exchange`: a send and a receive with the partner,
  in one ``batch_isend_irecv``).  Both fall back to the flat all-gather on
  non-power-of-two axes — same result, no staged structure — and the OR is
  always done locally after the words arrive: NCCL has no bitwise
  reduction op, so none is used.

* The **ring all-gather matmul** of the model tier
  (:func:`ring_allgather_matmul`, :func:`make_overlap_matmul`): the K
  blocks of ``x`` travel round the ring one step at a time while each
  rank multiplies the block it holds, so the all-gather overlaps the
  matmul.  Each step is one ring exchange (:func:`ring_shift`).

* A **byte ledger** (``comm_ledger``) records the per-rank bytes each
  collective moves.  The reference records while tracing, so one traced
  ``while_loop`` body gives one level's bytes; here the level loop runs on
  the host, so every executed call records, and a BFS of L levels records
  L levels' bytes, each level's equal to the reference's traced level.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

from repro_torch.errors import ConfigError

#: the tiled all-gather (``all_gather_into_tensor``, which newer torch
#: renames ``all_gather_single``)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
#: the tiled reduce-scatter (``reduce_scatter_tensor``, renamed likewise)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``mesh``'s named axis ``axis``; an axis the mesh lacks
    is a :class:`~repro_torch.errors.ConfigError`."""
    if axis not in mesh.mesh_dim_names:
        raise ConfigError(f"mesh_axis {axis!r} is not a dimension of the "
                          f"mesh {mesh.mesh_dim_names}")
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


# ---------------------------------------------------------------------------
# communication ledger
# ---------------------------------------------------------------------------
_LEDGER: list[tuple[str, int]] | None = None


def record_comm(label: str, nbytes: int) -> None:
    """Note ``nbytes`` of per-rank traffic under ``label`` if a ledger is
    open.  The collectives call this once per executed call."""
    if _LEDGER is not None:
        _LEDGER.append((label, int(nbytes)))


@contextlib.contextmanager
def comm_ledger():
    """Collect per-rank collective byte counts of the calls made inside::

        with comm_ledger() as events:
            prepared.levels(src)
        bytes_per_bfs = sum(n for _, n in events)

    Nested ledgers shadow (the inner one records)."""
    global _LEDGER
    prev = _LEDGER
    _LEDGER = events = []
    try:
        yield events
    finally:
        _LEDGER = prev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along dim 0 in rank
    order (records nothing: callers record their own label)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def reduce_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks of ``x``, split along dim 0 into one
    block a rank in rank order: this rank's block (the reference's tiled
    ``psum_scatter``; records nothing)."""
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x.contiguous(), group=group)
    return out


def _exchange(send: torch.Tensor, peer: int, group,
              source: int | None = None) -> torch.Tensor:
    """Send ``send`` to global rank ``peer`` and receive a block of the
    same shape from ``source`` (``peer`` when None): the reference's one
    ``ppermute`` stage, between a pair or around a ring."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, peer, group),
           dist.P2POp(dist.irecv, recv, peer if source is None else source,
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _partner(group, idx: int, bit: int) -> int:
    """The global rank of axis rank ``idx ^ bit`` of ``group``."""
    return dist.get_process_group_ranks(group)[idx ^ bit]


# ---------------------------------------------------------------------------
# butterfly frontier collectives (2-D partition, DESIGN §3)
# ---------------------------------------------------------------------------
def butterfly_frontier_exchange(seg: torch.Tensor, mesh, axis: str, *,
                                stall_stage: int | None = None
                                ) -> torch.Tensor:
    """Recursive-doubling all-gather of per-rank segments, index-ordered.

    Rank ``d`` of the axis contributes ``seg`` (leading-dim block ``d``);
    every rank returns ``cat([seg_0, ..., seg_{n-1}])`` along dim 0.  On a
    power-of-two axis this runs ``log2(n)`` pairwise stages — stage ``s``
    pairs ``d`` with ``d ^ (1 << s)`` and doubles the held block, keeping
    lower-indexed halves first so the result needs no final permutation.
    Non-power-of-two axes fall back to the flat all-gather (identical
    result, no staged structure).

    ``stall_stage`` is the fault seam (DESIGN §2.7): at that stage the
    partner's block is replaced with zeros — a stalled or timed-out
    transfer.  Ignored on the fallback path."""
    n = axis_size(mesh, axis)
    if n == 1:
        return seg
    group = mesh.get_group(axis)
    if n & (n - 1):  # non-power-of-two: flat gather moves the same bytes
        record_comm("butterfly_fallback_flat", (n - 1) * _nbytes(seg))
        return all_gather_tiled(seg, group)
    idx = mesh.get_local_rank(axis)
    buf = seg
    for s in range(n.bit_length() - 1):
        bit = 1 << s
        record_comm("butterfly_gather", _nbytes(buf))
        other = _exchange(buf, _partner(group, idx, bit), group)
        if stall_stage == s:
            other = torch.zeros_like(other)
        buf = torch.cat([buf, other] if idx & bit == 0 else [other, buf])
    return buf


def butterfly_or_allreduce(words: torch.Tensor, mesh, axis: str
                           ) -> torch.Tensor:
    """Bitwise-OR all-reduce of packed frontier words along a mesh axis.

    Power-of-two axes run recursive-halving reduce-scatter (each stage
    ORs the partner's half of the shrinking block) followed by the
    recursive-doubling all-gather — per-rank volume
    ``2 * nbytes * (1 - 1/n)`` instead of the flat gather's
    ``nbytes * (n - 1)``.  Requires dim 0 divisible by the axis size
    (guaranteed by the 32·cols row alignment of the 2-D partition);
    otherwise, and on non-power-of-two axes, it gathers every rank's words
    and ORs them here."""
    n = axis_size(mesh, axis)
    if n == 1:
        return words
    group = mesh.get_group(axis)
    if (n & (n - 1)) or words.shape[0] % n:
        record_comm("or_allreduce_fallback_flat", (n - 1) * _nbytes(words))
        gathered = all_gather_tiled(words, group).reshape(
            (n,) + tuple(words.shape))
        return functools.reduce(torch.bitwise_or, gathered.unbind(0))
    idx = mesh.get_local_rank(axis)
    buf = words
    stages = n.bit_length() - 1
    # recursive halving: after stage s the rank holds the OR over its
    # 2^(s+1)-rank group of a 1/2^(s+1) slice, position-encoded by the
    # low bits of idx so the doubling phase can reassemble in order
    for s in range(stages):
        bit = 1 << s
        half = buf.shape[0] // 2
        record_comm("or_reduce_scatter", _nbytes(buf) // 2)
        upper = idx & bit != 0
        keep, send = (buf[half:], buf[:half]) if upper else \
            (buf[:half], buf[half:])
        buf = keep | _exchange(send, _partner(group, idx, bit), group)
    # recursive doubling reassembles the full OR'd block: stage order is
    # reversed so the halving's position encoding unwinds exactly
    for s in reversed(range(stages)):
        bit = 1 << s
        record_comm("or_allgather", _nbytes(buf))
        other = _exchange(buf, _partner(group, idx, bit), group)
        buf = torch.cat([other, buf] if idx & bit else [buf, other])
    return buf


# ---------------------------------------------------------------------------
# ring all-gather matmul (the model tier's collective-matmul overlap)
# ---------------------------------------------------------------------------
def ring_shift(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Pass ``t`` one step round ``axis``'s ring: send it to axis rank
    ``idx + 1`` and return what axis rank ``idx - 1`` sent (the
    reference's ``ppermute`` with ``perm = [(i, (i + 1) % n)]``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    idx = mesh.get_local_rank(axis)
    return _exchange(t, ranks[(idx + 1) % n], group,
                     source=ranks[(idx - 1) % n])


def ring_allgather_matmul(x_blk: torch.Tensor, w_local: torch.Tensor,
                          mesh, axis: str) -> torch.Tensor:
    """This rank's ``y_local (M, N/n) = full_x @ w_local``, from
    ``x_blk`` (M, K/n), its K block of x, and ``w_local`` (K, N/n), the
    full-K rows of its N shard.  Step ``i`` multiplies the block held
    (axis rank ``idx - i``'s) by the matching rows of ``w_local`` and
    passes it on: n - 1 ring exchanges of ``x_blk``'s bytes, each in the
    ledger as ``ring_matmul_shift`` (the reference's loop also permutes
    after its last step, which moves nothing used)."""
    n = axis_size(mesh, axis)
    idx = mesh.get_local_rank(axis)
    kb = x_blk.shape[1]
    acc = torch.zeros((x_blk.shape[0], w_local.shape[1]),
                      dtype=torch.promote_types(x_blk.dtype, w_local.dtype),
                      device=x_blk.device)
    blk = x_blk
    for i in range(n):
        src = (idx - i) % n        # the block id this rank holds
        acc = acc + blk @ w_local[src * kb:(src + 1) * kb]
        if i < n - 1:
            record_comm("ring_matmul_shift", _nbytes(blk))
            blk = ring_shift(blk, mesh, axis)
    return acc


def make_overlap_matmul(mesh, axis: str = "model"):
    """The per-rank function ``f(x_blk, w_local) -> y_local`` of
    :func:`ring_allgather_matmul` over ``axis``: x sharded on K, w and y
    on N (the reference's ``shard_map`` over ``P(None, axis)``)."""
    return functools.partial(ring_allgather_matmul, mesh=mesh, axis=axis)

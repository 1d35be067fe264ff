"""Edge-partitioned graph parallelism: ONE large graph sharded over the
ranks of a mesh axis (counterpart of
``graphnets_tpu/parallel/edge_partition.py``).

Partition (host side, numpy, bit-equal to the JAX package's):

* nodes go to shards in contiguous blocks of ``npad`` ids (or by an
  explicit assignment, relabelled into such blocks);
* each edge lives on the shard that owns its receiver, so the edge->node
  sum is local; each shard's edges are stably sorted by local receiver and
  its pad slots target the overflow segment ``npad``, the sorted-pad-safe
  layout the sorted segment-sum and gather kernels take.

Blocks (one process a rank, SPMD): where JAX runs a ``shard_map`` body on
each shard, every rank of the mesh axis here runs the same body on its own
slice: JAX's ``P(axis)`` is "this rank's slice" (index
``mesh.get_local_rank(axis)`` of the ``[S, ...]`` arrays) and ``P()`` is
"the same on every rank".  A block takes the whole ``[S, ...]`` graph (and
slices it) or this rank's ``[1, ...]`` slice (:meth:`PartitionedGraph.shard`)
and returns this rank's slice of the output, ``gf`` the same on every rank.
The collectives are ``parallel/_comm``'s, differentiable: v1 all-gathers
the node rows (:func:`gn_block_partitioned`), v2 exchanges only the
boundary rows in one all-to-all (:func:`build_halo_plan`,
:func:`gn_block_partitioned_halo`), v3 exchanges the sender term already
transformed (:func:`block_local_v3`, :func:`gn_block_partitioned_overlap`);
each sums the graph pools in one ``psum``.  ``mesh=None`` is one process
(``S = 1``).  Parameter gradients are partial on each rank and are summed
over the axis (``edge_partition_stack.make_partitioned_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.gn_block import GNBlock, _linear_split
from ..nn.core import layer_norm
from ..ops import scatter
from ..ops.ln_linear import matmul_f32
from ..utils.config import g1_agg_fusion_training, resolve_device, use_kernels
from . import _comm

__all__ = ["partition_edges", "PartitionedGraph", "gn_block_partitioned",
           "gn_block_partitioned_overlap", "gather_remote_node_features",
           "block_local_v3", "HaloPlan", "build_halo_plan",
           "gn_block_partitioned_halo", "bfs_node_order",
           "partition_edges_assigned", "partition_edges_mincut",
           "partition_edges_locality"]


@dataclasses.dataclass
class PartitionedGraph:
    """One big graph, edge-partitioned over ``S`` shards.

    Tensors carry a leading shard axis ``[S, ...]``:

    * ``senders_global [S, Epad]`` int32: global id of each local edge's
      source (may be remote);
    * ``receivers_local [S, Epad]`` int32: shard-local id of the
      destination, ``npad`` on pad slots;
    * ``edge_mask [S, Epad]``, ``node_mask [S, Npad]`` bool;
    * ``nf [S, Npad, DN]``: shard ``s`` owns global nodes ``[s * Npad,
      (s + 1) * Npad)``;
    * ``ef [S, Epad, DE]`` optional edge features;
    * ``gf [1, DG]`` optional global features (the same on every shard).

    ``edge_index [S, Epad]`` (numpy int64, pad -1) maps each shard slot
    back to the caller's edge array.
    """

    senders_global: torch.Tensor
    receivers_local: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    nf: torch.Tensor
    ef: Optional[torch.Tensor] = None
    gf: Optional[torch.Tensor] = None
    edge_index: Optional[np.ndarray] = None

    @property
    def num_shards(self) -> int:
        return int(self.senders_global.shape[0])

    @property
    def nodes_per_shard(self) -> int:
        return int(self.nf.shape[1])

    def replace(self, **kw) -> "PartitionedGraph":
        return dataclasses.replace(self, **kw)

    def shard(self, index: int, device=None) -> "PartitionedGraph":
        """Shard ``index`` alone (leading axis 1) on ``device`` (``cuda``
        unless the caller asks for the CPU); ``gf`` whole."""
        device = resolve_device(device)
        take = lambda t: None if t is None else \
            t[index:index + 1].to(device)
        return PartitionedGraph(
            senders_global=take(self.senders_global),
            receivers_local=take(self.receivers_local),
            edge_mask=take(self.edge_mask), node_mask=take(self.node_mask),
            nf=take(self.nf), ef=take(self.ef),
            gf=None if self.gf is None else self.gf.to(device),
            edge_index=(None if self.edge_index is None
                        else self.edge_index[index:index + 1]))


def _tensors(device, **arrays):
    return {k: None if a is None else torch.from_numpy(a).to(device)
            for k, a in arrays.items()}


def partition_edges(senders: np.ndarray, receivers: np.ndarray,
                    nf: np.ndarray, num_shards: int,
                    ef: Optional[np.ndarray] = None,
                    gf: Optional[np.ndarray] = None,
                    edge_pad_multiple: int = 128,
                    device=None) -> PartitionedGraph:
    """Host-side partitioner: contiguous node blocks, edges to the
    receiver's owner shard, equal static pad sizes across shards.  Each
    shard's edges are stably sorted by local receiver and its pad slots
    target the overflow segment ``npad``.  The tensors go to ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    N = nf.shape[0]
    npad = -(-N // num_shards)
    nf_padded = np.zeros((num_shards * npad, nf.shape[1]), np.float32)
    nf_padded[:N] = nf
    return _partition_relabelled(
        senders, receivers, nf_padded, num_shards, npad, ef, gf,
        edge_pad_multiple, np.clip(N - npad * np.arange(num_shards), 0, npad),
        device, min_edges=0)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """``(group, size, coord)`` of ``axis``: its process group, its number
    of ranks and this rank's coordinate on it; ``(None, 1, 0)`` without a
    mesh."""
    if mesh is None:
        return None, 1, 0
    return (mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def _lead(item) -> torch.Tensor:
    return item.sender_pos if isinstance(item, HaloPlan) else item.nf


def _local(item, mesh: Optional[DeviceMesh], axis: str):
    """This rank's ``[1, ...]`` slice of a :class:`PartitionedGraph` or
    :class:`HaloPlan` on the mesh's device (``item`` itself where it holds
    one shard there already)."""
    _, size, coord = axis_group(mesh, axis)
    n = item.num_shards
    if n not in (1, size):
        raise ValueError(f"{type(item).__name__} of {n} shards on an axis "
                         f"{axis!r} of {size} ranks")
    if mesh is None:
        device = _lead(item).device
    elif mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    if n == 1 and _lead(item).device == device:
        return item
    return item.shard(coord if n == size else 0, device)


def gather_remote_node_features(nf_local: torch.Tensor,
                                global_idx: torch.Tensor,
                                group) -> torch.Tensor:
    """All-gather the node rows over ``group``, then gather by global id
    (v1 halo exchange).  ``nf_local [Npad, DN]``: this shard's block;
    ``global_idx [Epad]``: global node ids, clipped into range."""
    all_nf = _comm.all_gather_grad(nf_local, 0, group)   # [S * Npad, DN]
    return all_nf.index_select(0, global_idx.clamp(0, all_nf.shape[0] - 1))


def _unpack(lg: PartitionedGraph):
    """The squeezed shard tensors, zero-width ``ef`` / ``gf`` for absent
    ones."""
    nf = lg.nf[0]
    Epad = lg.receivers_local.shape[1]
    ef = lg.ef[0] if lg.ef is not None else nf.new_zeros(Epad, 0)
    gf = lg.gf if lg.gf is not None else nf.new_zeros(1, 0)
    return (lg.senders_global[0], lg.receivers_local[0], lg.edge_mask[0],
            lg.node_mask[0], nf, ef, gf)


def _pools(h_ef, h_nf, em, nm, group) -> torch.Tensor:
    """The edge and node sums over real slots, summed over the axis: f32
    partial sums, their f32 ``psum``, one rounding to the rows' type (as
    the unpartitioned single graph's pools round once after their f32
    sum), so a partition changes only the order of the f32 sum."""
    total = lambda h, m: torch.where(m[:, None], h, 0).sum(
        0, dtype=torch.float32)
    pools = _comm.psum(torch.cat([total(h_ef, em), total(h_nf, nm)]), group)
    return pools.to(torch.promote_types(h_ef.dtype, h_nf.dtype))


def _repack(lg: PartitionedGraph, block: GNBlock, h_ef, h_nf, h_gf
            ) -> PartitionedGraph:
    de_o, _, dg_o = block.out_dims
    return lg.replace(ef=h_ef[None] if de_o > 0 else None, nf=h_nf[None],
                      gf=h_gf if dg_o > 0 else None)


def _composed_block(block: GNBlock, lg: PartitionedGraph, src, group):
    """The v1 / v2 body after the sender rows ``src [Epad, DN]`` are in:
    the update nets on concatenated inputs, as the unpartitioned block
    without split-linear."""
    _, rl, em, nm, nf, ef, gf = _unpack(lg)
    Epad, Npad = rl.shape[0], nf.shape[0]
    dst = nf.index_select(0, rl.clamp(max=Npad - 1))
    g2e = gf[0].expand(Epad, gf.shape[1])
    h_ef = block.edgefn(torch.cat([ef, src, dst, g2e], -1))
    # Receiver-sorted shard order; pads target segment Npad, masked and
    # sliced off (JAX drops them as out-of-range ids).
    agg = scatter.segment_sum(h_ef, rl, Npad + 1, em)[:Npad]
    g2n = gf[0].expand(Npad, gf.shape[1])
    h_nf = block.nodefn(torch.cat([agg, nf, g2n], -1))
    pools = _pools(h_ef, h_nf, em, nm, group)
    h_gf = block.graphfn(torch.cat([pools, gf[0]])[None, :])
    return _repack(lg, block, h_ef, h_nf, h_gf)


def gn_block_partitioned(block: GNBlock, pg: PartitionedGraph,
                         mesh: Optional[DeviceMesh] = None,
                         axis: str = "graph") -> PartitionedGraph:
    """A GNBlock over an edge-partitioned graph (v1): one all-gather of the
    node rows (sender halo) and one ``psum`` (graph pools) a block.
    Equals the unpartitioned block on real slots."""
    group = axis_group(mesh, axis)[0]
    lg = _local(pg, mesh, axis)
    sg, nf = lg.senders_global[0], lg.nf[0]
    return _composed_block(block, lg,
                           gather_remote_node_features(nf, sg, group), group)


@dataclasses.dataclass
class HaloPlan:
    """Static exchange plan for boundary node rows, built on the host from
    the edge partition.  For shard ``s``:

    * ``send_idx [S, S, H]``: local ids of the rows shard ``s`` sends to
      peer ``t`` (the senders of t's edges that live on s), padded with 0
      and masked by ``send_mask``;
    * ``sender_pos [S, Epad]``: for every local edge, the position of its
      sender's row in ``[local nf (Npad) | halo (S * H)]``: local senders
      below ``Npad``, remote ones where the all-to-all deposits them.

    A layer moves ``2 * H * S * D`` values a rank (an all-to-all), against
    ``(S - 1) * Npad * D`` for v1's all-gather.
    """

    send_idx: torch.Tensor    # [S, S, H] int32
    send_mask: torch.Tensor   # [S, S, H] bool
    sender_pos: torch.Tensor  # [S, Epad] int32

    @property
    def halo_size(self) -> int:
        return int(self.send_idx.shape[2])

    @property
    def num_shards(self) -> int:
        return int(self.sender_pos.shape[0])

    def shard(self, index: int, device=None) -> "HaloPlan":
        """Shard ``index``'s plan alone (leading axis 1) on ``device``
        (``cuda`` unless the caller asks for the CPU)."""
        device = resolve_device(device)
        take = lambda t: t[index:index + 1].to(device)
        return HaloPlan(take(self.send_idx), take(self.send_mask),
                        take(self.sender_pos))


def build_halo_plan(pg: PartitionedGraph, halo_pad_multiple: int = 8
                    ) -> HaloPlan:
    """Host-side construction of the boundary-exchange plan; its tensors
    go where ``pg``'s are."""
    S = pg.num_shards
    npad = pg.nodes_per_shard
    sg = pg.senders_global.cpu().numpy()
    em = pg.edge_mask.cpu().numpy()
    Epad = sg.shape[1]

    # needed[s][t]: sorted unique global sender ids shard s needs from t.
    needed = [[None] * S for _ in range(S)]
    H = 1
    for s in range(S):
        owners = np.minimum(sg[s] // npad, S - 1)
        for t in range(S):
            ids = np.unique(sg[s][(owners == t) & em[s] & (t != s)])
            needed[s][t] = ids
            H = max(H, len(ids))
    H = int(-(-H // halo_pad_multiple) * halo_pad_multiple)

    send_idx = np.zeros((S, S, H), np.int32)
    send_mask = np.zeros((S, S, H), bool)
    for s in range(S):
        for t in range(S):
            ids = needed[t][s]  # what t needs from s: s sends these
            send_idx[s, t, : len(ids)] = ids - s * npad
            send_mask[s, t, : len(ids)] = True

    sender_pos = np.zeros((S, Epad), np.int32)
    for s in range(S):
        owners = np.minimum(sg[s] // npad, S - 1)
        pos = np.zeros(Epad, np.int64)
        local = owners == s
        pos[local] = sg[s][local] - s * npad
        for t in range(S):
            if t == s:
                continue
            sel = (owners == t) & em[s]
            if not sel.any():
                continue
            # After the all-to-all, rows from peer t sit at npad + t * H.
            slot = np.searchsorted(needed[s][t], sg[s][sel])
            pos[sel] = npad + t * H + slot
        sender_pos[s] = pos
    return HaloPlan(**_tensors(pg.senders_global.device, send_idx=send_idx,
                               send_mask=send_mask, sender_pos=sender_pos))


def _halo_table(rows: torch.Tensor, send_idx: torch.Tensor, group
                ) -> torch.Tensor:
    """``[rows (Npad) | halo (S * H)]``: the rows each peer needs from this
    shard, exchanged in one all-to-all and appended."""
    S, H = send_idx.shape
    outgoing = rows.index_select(0, send_idx.reshape(-1)).reshape(S, H, -1)
    halo = _comm.all_to_all_grad(outgoing, group)
    return torch.cat([rows, halo.reshape(S * H, -1)], 0)


def gn_block_partitioned_halo(block: GNBlock, pg: PartitionedGraph,
                              plan: HaloPlan,
                              mesh: Optional[DeviceMesh] = None,
                              axis: str = "graph") -> PartitionedGraph:
    """Edge-partitioned GNBlock with a boundary all-to-all (v2): v1's
    semantics, moving only the boundary rows."""
    group = axis_group(mesh, axis)[0]
    lg, lp = _local(pg, mesh, axis), _local(plan, mesh, axis)
    table = _halo_table(lg.nf[0], lp.send_idx[0], group)
    pos = lp.sender_pos[0].clamp(0, table.shape[0] - 1)
    return _composed_block(block, lg, table.index_select(0, pos), group)


def block_local_v3(block: GNBlock, send_idx, sender_pos, rl, em, nm, nf, ef,
                   gf, group, ef_ln: Optional[dict] = None,
                   training: bool = False):
    """One shard's GNBlock body with the v3 halo (transform before
    exchange).  The tensors are this shard's, without the shard axis
    (``ef`` / ``gf`` may be ``None``); returns ``(h_ef, h_nf, h_gf)``,
    ``h_gf`` the same on every rank (computed from summed pools).

    The shard layout is the single-graph kernels' (receivers ascending,
    pads on the overflow segment ``Npad``), so the body takes the same
    kernels as the unpartitioned block where the JAX package's gates hold:
    with kernels on, the single-graph edge update with its edge->node sum
    (``ef_ln`` fused, receivers table padded to ``N2`` rows with zero rows
    past ``Npad``; under training only with ``g1_agg_fusion_training``);
    else the sender term by ``take_rows_sorted_grad``, the receiver term by
    ``sorted_gather_add``, the row completed by ``ln_matmul`` with the f32
    sum as its addend, and the mask-free sorted segment sum over ``Npad +
    1`` segments.  ``t_src`` / ``t_dst`` round to ``nf.dtype`` before the
    exchange, whatever ``bf16_gather_partials`` says.  ``ef_ln``: the
    GNCore's pre-block edge LayerNorm, fused with kernels on, applied first
    otherwise."""
    de, dn, dg = block.in_dims
    de_o = block.out_dims[0]
    if dn <= 0:
        raise ValueError("transform-before-exchange needs node features")
    Epad, Npad = rl.shape[0], nf.shape[0]
    ef = ef if ef is not None else nf.new_zeros(Epad, 0)
    gf = gf if gf is not None else nf.new_zeros(1, 0)

    if ef_ln is not None and not (use_kernels() and de > 0):
        ef = layer_norm(ef, ef_ln["scale"], ef_ln["bias"])
        ef_ln = None

    w, b = block.edgefn.w, block.edgefn.b
    w_ef, w_src = w[:de], w[de:de + dn]
    w_dst, w_g = w[de + dn:de + 2 * dn], w[de + 2 * dn:de + 2 * dn + dg]

    # Sender term: transform locally, exchange the transformed rows.
    t_src = matmul_f32(nf, w_src).to(nf.dtype)              # [Npad, DE']
    table = _halo_table(t_src, send_idx, group)
    t_dst = matmul_f32(nf, w_dst).to(nf.dtype)

    h_ef = agg = None
    if (use_kernels() and de > 0
            and (not training or g1_agg_fusion_training())):
        from ..ops.kernels.edge_update_g1 import (fused_g1_edge_update_agg,
                                                  supports_g1_edge_update)
        pad_rows = (32 - Npad % 32) or 32          # >= 1 overflow row
        N2 = Npad + pad_rows
        if supports_g1_edge_update(Epad, N2, de, de_o, ef.element_size(),
                                   with_agg=True,
                                   part_itemsize=t_dst.element_size()):
            tr2 = torch.cat([t_dst, t_dst.new_zeros(pad_rows, de_o)], 0)
            gb = torch.zeros(de_o, dtype=torch.float32, device=nf.device)
            if dg > 0:
                gb = gb + matmul_f32(gf, w_g)[0]
            if b is not None:
                gb = gb + b.float()
            # The sender rows are dead after the kernel, which writes h
            # over them where the types match (as GNBlock passes them).
            src_term = scatter.take_rows_sorted_grad(table, sender_pos)
            h_ef, agg_full = fused_g1_edge_update_agg(
                ef, ef_ln, w_ef, src_term, tr2, rl, gb, src_is_dead=True)
            h_ef = h_ef.to(nf.dtype)
            agg = agg_full[:Npad].to(nf.dtype)

    if h_ef is None:
        # The composed route, with the kernel's rounding points.
        acc = scatter.take_rows_sorted_grad(table, sender_pos).float()
        if dg > 0:
            acc = acc + matmul_f32(gf, w_g)[0]
        if b is not None:
            acc = acc + b.float()
        # Receiver term: rl ascends; pads clamp into range and are masked
        # downstream, like the unpartitioned layout's.
        rl_g = rl.clamp(max=Npad - 1)
        fused_dst = False
        if use_kernels():
            from ..ops.kernels.gather import (sorted_gather_add,
                                              supports_sorted_gather)
            if supports_sorted_gather(Epad, Npad, de_o, t_dst.element_size()):
                acc = sorted_gather_add(t_dst, rl_g, acc)
                fused_dst = True
        if not fused_dst:
            acc = acc + scatter.take_rows_sorted_grad(
                t_dst, rl_g, idx_sorted=True).float()
        if de > 0 and ef_ln is not None:
            from ..ops.kernels.ln_linear import ln_matmul
            h_ef = ln_matmul(ef, ef_ln["scale"], ef_ln["bias"], w_ef,
                             addend=acc).to(nf.dtype)
        elif de > 0:
            h_ef = (matmul_f32(ef, w_ef) + acc).to(nf.dtype)
        else:
            h_ef = acc.to(nf.dtype)
        # Pads sit on the overflow segment Npad, sliced off: the mask-free
        # sorted sum's contract.
        agg = scatter.segment_sum(h_ef, rl, Npad + 1,
                                  sorted_pad_safe=True)[:Npad]
    h_nf = _linear_split(block.nodefn, nf.dtype,
                         [(agg, None), (nf, None), (gf, None)], rows=Npad)
    pools = _pools(h_ef, h_nf, em, nm, group)
    h_gf = block.graphfn(torch.cat([pools, gf[0]])[None, :])
    return h_ef, h_nf, h_gf


def gn_block_partitioned_overlap(block: GNBlock, pg: PartitionedGraph,
                                 plan: HaloPlan,
                                 mesh: Optional[DeviceMesh] = None,
                                 axis: str = "graph") -> PartitionedGraph:
    """Edge-partitioned GNBlock, v3: the edge net is one linear layer, so
    its sender term is computed before the exchange (``nf @ W_src`` at
    ``Npad`` rows) and the all-to-all moves transformed rows (``DE'`` wide
    instead of ``DN``).  v1's semantics; the partial terms accumulate in
    f32 as the unpartitioned split-linear path's.  The body is
    :func:`block_local_v3`, shared with the partitioned stack."""
    group = axis_group(mesh, axis)[0]
    lg, lp = _local(pg, mesh, axis), _local(plan, mesh, axis)
    _, rl, em, nm, nf, _, _ = _unpack(lg)
    h_ef, h_nf, h_gf = block_local_v3(
        block, lp.send_idx[0], lp.sender_pos[0], rl, em, nm, nf,
        None if lg.ef is None else lg.ef[0], lg.gf, group)
    return _repack(lg, block, h_ef, h_nf, h_gf)


def bfs_node_order(senders: np.ndarray, receivers: np.ndarray,
                   num_nodes: int, start: int = 0) -> np.ndarray:
    """BFS (Cuthill-McKee-style) node order over the undirected skeleton:
    contiguous blocks of it keep neighbourhoods on one shard, shrinking
    the halo.  Returns ``order`` with ``order[new_id] = old_id``."""
    from ..runtime import native
    und_s = np.concatenate([senders, receivers]).astype(np.int64)
    und_r = np.concatenate([receivers, senders]).astype(np.int64)
    indptr, adj = native.csc_from_coo(und_s, und_r, num_nodes)
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    k = 0
    for seed in range(num_nodes):
        seed = (seed + start) % num_nodes
        if visited[seed]:
            continue
        queue = [seed]
        visited[seed] = True
        while queue:
            nxt = []
            for v in queue:
                order[k] = v
                k += 1
                nbrs = adj[indptr[v]: indptr[v + 1]]
                for u in np.unique(nbrs):
                    if not visited[u]:
                        visited[u] = True
                        nxt.append(int(u))
            queue = sorted(nxt)
    assert k == num_nodes
    return order


def partition_edges_assigned(senders: np.ndarray, receivers: np.ndarray,
                             nf: np.ndarray, assign: np.ndarray,
                             num_shards: int,
                             ef: Optional[np.ndarray] = None,
                             gf: Optional[np.ndarray] = None,
                             edge_pad_multiple: int = 128, device=None
                             ) -> Tuple[PartitionedGraph, np.ndarray]:
    """Partition by an explicit node -> shard ``assign``.  Nodes are
    relabelled so each shard's are contiguous (``order[new_id] =
    old_id``; shard ``s`` owns new ids ``[s * npad, s * npad + k_s)``).
    Returns ``(pg, order)``."""
    S = num_shards
    assign = np.asarray(assign, np.int64)
    counts = np.bincount(assign, minlength=S)
    npad = int(counts.max())
    order = np.argsort(assign, kind="stable")       # grouped by shard
    new_of_old = np.empty(len(assign), np.int64)
    pos = 0
    for s in range(S):
        k = int(counts[s])
        new_of_old[order[pos:pos + k]] = s * npad + np.arange(k)
        pos += k
    nf_new = np.zeros((S * npad, nf.shape[1]), nf.dtype)
    nf_new[new_of_old] = nf
    pg = _partition_relabelled(new_of_old[senders], new_of_old[receivers],
                               nf_new, S, npad, ef=ef, gf=gf,
                               edge_pad_multiple=edge_pad_multiple,
                               real_counts=counts, device=device)
    return pg, order


def _partition_relabelled(senders, receivers, nf_padded, S, npad, ef, gf,
                          edge_pad_multiple, real_counts, device=None,
                          min_edges=1):
    """A PartitionedGraph from shard-blocked node ids (shard ``s`` owns
    ``[s * npad, s * npad + real_counts[s])``): each edge goes to its
    receiver's shard (``min(r // npad, S - 1)``), each shard's edges are
    stably sorted by local receiver, and its pad slots, up to the largest
    shard's count (at least ``min_edges``) rounded up to
    ``edge_pad_multiple``, target the overflow segment ``npad``."""
    owner = np.minimum(receivers // npad, S - 1)
    counts = np.bincount(owner, minlength=S)
    epad = int(-(-max(int(counts.max()), min_edges) // edge_pad_multiple)
               * edge_pad_multiple)
    sg = np.zeros((S, epad), np.int32)
    rl = np.full((S, epad), npad, np.int32)   # pads -> overflow segment
    em = np.zeros((S, epad), bool)
    eidx = np.full((S, epad), -1, np.int64)
    nm = np.zeros((S, npad), bool)
    nfp = np.zeros((S, npad, nf_padded.shape[1]), np.float32)
    efp = (np.zeros((S, epad, ef.shape[1]), np.float32)
           if ef is not None else None)
    for s in range(S):
        sel = np.where(owner == s)[0]
        rls = receivers[sel] - s * npad
        sel = sel[np.argsort(rls, kind="stable")]
        k = len(sel)
        sg[s, :k] = senders[sel]
        rl[s, :k] = receivers[sel] - s * npad
        em[s, :k] = True
        eidx[s, :k] = sel
        nm[s, : int(real_counts[s])] = True
        nfp[s] = nf_padded[s * npad:(s + 1) * npad]
        if ef is not None:
            efp[s, :k] = ef[sel]
    return PartitionedGraph(
        **_tensors(resolve_device(device), senders_global=sg,
                   receivers_local=rl, edge_mask=em, node_mask=nm, nf=nfp,
                   ef=efp, gf=None if gf is None
                   else gf[None, :].astype(np.float32)),
        edge_index=eidx)


def partition_edges_mincut(senders: np.ndarray, receivers: np.ndarray,
                           nf: np.ndarray, num_shards: int,
                           ef: Optional[np.ndarray] = None,
                           gf: Optional[np.ndarray] = None,
                           edge_pad_multiple: int = 128,
                           imbalance: float = 1.05, passes: int = 8,
                           device=None
                           ) -> Tuple[PartitionedGraph, np.ndarray]:
    """Min-edge-cut partition: the BFS-contiguous assignment refined by the
    native greedy pass (``runtime.native.refine_partition``) under a cap of
    ``imbalance * ceil(N / S)`` nodes a shard.  Returns ``(pg, order)`` as
    :func:`partition_edges_assigned`."""
    from ..runtime import native
    N = nf.shape[0]
    order = bfs_node_order(senders, receivers, N)
    inv = np.empty_like(order)
    inv[order] = np.arange(N)
    block = -(-N // num_shards)
    assign = np.minimum(inv // block, num_shards - 1)
    und_s = np.concatenate([senders, receivers]).astype(np.int64)
    und_r = np.concatenate([receivers, senders]).astype(np.int64)
    indptr, adj = native.csc_from_coo(und_s, und_r, N)
    cap = int(imbalance * block) + 1
    assign, _ = native.refine_partition(indptr, adj, assign, num_shards,
                                        cap=cap, passes=passes)
    return partition_edges_assigned(senders, receivers, nf, assign,
                                    num_shards, ef=ef, gf=gf,
                                    edge_pad_multiple=edge_pad_multiple,
                                    device=device)


def partition_edges_locality(senders: np.ndarray, receivers: np.ndarray,
                             nf: np.ndarray, num_shards: int,
                             ef: Optional[np.ndarray] = None,
                             gf: Optional[np.ndarray] = None,
                             edge_pad_multiple: int = 128, device=None
                             ) -> Tuple[PartitionedGraph, np.ndarray]:
    """BFS-reordered edge partition.  Returns ``(pg, order)``,
    ``order[new_id] = old_id``: shard ``s``'s node block holds old nodes
    ``order[s * npad : (s + 1) * npad]``."""
    order = bfs_node_order(senders, receivers, nf.shape[0])
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    pg = partition_edges(inv[senders], inv[receivers], nf[order],
                         num_shards, ef=ef, gf=gf,
                         edge_pad_multiple=edge_pad_multiple, device=device)
    return pg, order

"""Pipeline parallelism for GNCore stacks, GPipe order over ``send`` /
``recv`` (counterpart of ``graphnets_tpu/parallel/pipeline.py``).

The mesh's ``pipe`` axis holds S stages; stage ``s`` owns cores ``s*k ..
s*k+k-1``.  A stacked batch of M microbatches streams through: stage ``s``
runs microbatch ``t - s`` at tick ``t``, and only the features ``(ef, nf,
gf)`` pass from stage to stage; the graph structure is the same on every
rank, which reads microbatch ``m``'s structure locally.  The bubble is
``(S - 1) / (M + S - 1)`` of the ticks.  The last stage's outputs are
broadcast to every stage, as JAX's final ``psum`` replicates them.

The schedule runs explicitly inside one ``autograd.Function`` a rank:
its forward runs the ticks, keeping each microbatch's graph of the
stage; its backward takes the cotangent of the outputs on the last stage
(every rank computes the same loss of the replicated outputs, so it is
counted once) and runs the microbatches back in order, each stage
receiving the gradient of its outputs from the next stage and sending the
gradient of its inputs to the previous one.  Every rank posts its sends
and receives in one microbatch order, so blocking ``send`` / ``recv``
cannot deadlock.  The gradients reach the stage's parameters (as the
module holds them when called, the compute-dtype casts of a training
step included) and, on stage 0, the microbatches' features.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from ..graph import GraphsTuple
from ..models.gn_core import GNCoreList
from ..utils.tree import map_tensors
from . import _comm

__all__ = ["PipelinedCoreList"]


class _Schedule:
    """One call's settings: this rank's stage module, the pipe group, the
    stacked microbatches' structure and the cores' call arguments."""

    def __init__(self, stage: nn.Module, sid: int, S: int, group, micros,
                 training: bool, generator):
        self.stage, self.sid, self.S, self.group = stage, sid, S, group
        self.micros, self.training, self.generator = (micros, training,
                                                      generator)
        self.names = [n for n, _ in stage.named_parameters()]
        self.peer = lambda s: dist.get_global_rank(group, s)

    def run(self, params, feats, m: int):
        g = map_tensors(lambda t: t[m], self.micros)
        g = g.with_features(ef=feats[0], nf=feats[1], gf=feats[2])
        y = functional_call(self.stage, dict(zip(self.names, params)), (g,),
                            {"training": self.training,
                             "generator": self.generator})
        return y.ef, y.nf, y.gf


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sch: _Schedule, n_params: int, *inputs):
        params, stacked = inputs[:n_params], inputs[n_params:]
        sid, S, M = sch.sid, sch.S, stacked[0].shape[0]
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        saved: List[Tuple] = []
        outs = [torch.empty_like(f) for f in stacked]
        with torch.enable_grad():
            for t in range(M + S - 1):
                m = t - sid
                if not 0 <= m < M:
                    continue
                if sid == 0:
                    xs = [f[m].detach() for f in stacked]
                else:
                    xs = [_comm.recv(f[m], sch.peer(sid - 1), sch.group)
                          for f in stacked]
                xs = [x.requires_grad_() for x in xs]
                ys = sch.run(leaves, xs, m)
                saved.append((xs, ys))
                if sid < S - 1:
                    for y in ys:
                        _comm.send(y.detach(), sch.peer(sid + 1), sch.group)
                else:
                    for o, y in zip(outs, ys):
                        o[m] = y.detach()
        for o in outs:
            _comm.broadcast_(o, sch.peer(S - 1), sch.group)
        ctx.sch, ctx.leaves, ctx.saved = sch, leaves, saved
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        sch, leaves = ctx.sch, ctx.leaves
        sid, S = sch.sid, sch.S
        dparams = [None] * len(leaves)
        dfeats = [torch.zeros_like(g) for g in grads] if sid == 0 else None
        for m, (xs, ys) in enumerate(ctx.saved):
            if sid == S - 1:
                gys = [g[m] for g in grads]
            else:
                gys = [_comm.recv(y, sch.peer(sid + 1), sch.group)
                       for y in ys]
            wrt = list(xs) + [p for p in leaves if p.requires_grad]
            got = torch.autograd.grad(ys, wrt, gys, allow_unused=True)
            gxs, gps = got[:len(xs)], iter(got[len(xs):])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(gps)
                    if gp is not None:
                        dparams[i] = gp if dparams[i] is None \
                            else dparams[i] + gp
            gxs = [torch.zeros_like(x) if g is None else g
                   for x, g in zip(xs, gxs)]
            if sid > 0:
                for gx in gxs:
                    _comm.send(gx, sch.peer(sid - 1), sch.group)
            else:
                for d, gx in zip(dfeats, gxs):
                    d[m] = gx
        ctx.saved = None
        feats = [None] * len(grads) if dfeats is None else dfeats
        return (None, None, *dparams, *feats)


class PipelinedCoreList(nn.Module):
    """A ``GNCoreList`` split into ``num_stages`` pipeline stages.

    ``stages[s]`` is a ``GNCoreList`` of stage ``s``'s cores (named
    ``"0"``, ``"1"``, ... as a stage of the JAX tree); every rank builds
    all of them, so the structure is the same on every rank, and trains
    only its own.  ``forward(micros, mesh)`` takes a stacked batch of M
    microbatches (``data_parallel.stack_shards``; identical pad sizes) and
    returns the stacked outputs on every stage.  ``sequential()`` is the
    equivalent unpipelined module, over the same core modules.
    """

    def __init__(self, cores: Sequence[nn.Module], num_stages: int,
                 axis: str = "pipe"):
        super().__init__()
        if len(cores) % num_stages:
            raise ValueError("cores must divide evenly into stages")
        if len({getattr(c, "dims", None) for c in cores}) != 1:
            raise ValueError("pipeline stages must share dims")
        self.num_stages, self.axis = num_stages, axis
        # A module passed more than once is copied, as GNCoreList does, so
        # every position owns its parameters.
        seen, owned = set(), []
        for core in cores:
            owned.append(copy.deepcopy(core) if id(core) in seen else core)
            seen.add(id(core))
        cores, k = owned, len(cores) // num_stages
        self.stages = nn.ModuleList(
            GNCoreList(list(cores[s * k:(s + 1) * k]))
            for s in range(num_stages))

    @property
    def cores_per_stage(self) -> int:
        return len(list(self.stages[0].children()))

    def sequential(self) -> GNCoreList:
        """The equivalent unpipelined module (the same core modules)."""
        return GNCoreList([c for st in self.stages for c in st.children()])

    def forward(self, micros: GraphsTuple, mesh: DeviceMesh,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> GraphsTuple:
        group = mesh.get_group(self.axis)
        S = dist.get_world_size(group)
        if S != self.num_stages:
            raise ValueError(f"PipelinedCoreList: {self.num_stages} stages "
                             f"on a {self.axis!r} axis of {S} ranks")
        sid = mesh.get_local_rank(self.axis)
        stage = self.stages[sid]
        sch = _Schedule(stage, sid, S, group, micros, training, generator)
        params = [p for _, p in stage.named_parameters()]
        ef, nf, gf = _Pipeline.apply(sch, len(params), *params, micros.ef,
                                     micros.nf, micros.gf)
        return micros.with_features(ef=ef, nf=nf, gf=gf)

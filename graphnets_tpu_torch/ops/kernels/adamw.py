"""AdamW / Adam update of many f32 tensors in one launch.

    p *= 1 - lr wd;  m = lerp(m, g, 1 - b1);  v = b2 v + (1 - b2) g g
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)

with ``t`` each tensor's step count after its increment, torch's
decoupled AdamW (``wd = 0`` for Adam) in torch's capturable foreach order,
in f32.  A missing gradient (``None``) is a zero gradient: the tensor is
decayed and its moments advance, as ``optax.adamw`` does.

Kernel: ``csrc/adamw.cu``.  It replaces no Pallas call: the JAX package
leaves ``optax.adamw`` to XLA.  It is bound by bytes (28 a value), and
runs as one grid over every tensor's values: the table of tensors goes in
the kernel's arguments, so a CUDA-graph capture keeps the addresses it
captured, and a list longer than :data:`MAX_TENSORS` (the 4 KB argument
limit) takes one launch per :data:`MAX_TENSORS` tensors.  The step counts
advance in one foreach add before the launches.  :func:`plan` is
the host's half (blocks per tensor, 16-byte bodies); :func:`adamw_update`
launches it for CUDA tensors and takes :func:`adamw_update_plain` for CPU
tensors.  ``training/optim.py`` drives it from ``optimizer.step()``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from . import _build

__all__ = ["adamw_update", "adamw_update_plain", "plan", "Launch",
           "MAX_TENSORS", "UNITS_PER_BLOCK", "LAUNCHES"]

LAUNCHES = 0          # kernel launches, for proving the path was taken
MAX_TENSORS = 80      # tensors a launch (csrc/adamw.cu kMaxTensors)
UNITS_PER_BLOCK = 1024  # 16-byte units (or single values) a block
_NUMEL_LIMIT = 2 ** 31

_P = ctypes.c_void_p * MAX_TENSORS


class _Table(ctypes.Structure):
    """``csrc/adamw.cu``'s ``Table``, field for field."""
    _fields_ = [("p", _P), ("g", _P), ("m", _P), ("v", _P), ("step", _P),
                ("numel", ctypes.c_int * MAX_TENSORS),
                ("block_start", ctypes.c_int * (MAX_TENSORS + 1)),
                ("head", ctypes.c_byte * MAX_TENSORS),
                ("n", ctypes.c_int),
                ("lr_ptr", ctypes.c_void_p),
                *[(k, ctypes.c_float) for k in (
                    "lr", "decay", "beta1", "beta2", "one_minus_beta1",
                    "one_minus_beta2", "eps", "wd")]]


@dataclasses.dataclass
class Launch:
    """One launch of the kernel: tensors ``first`` to ``first + len(heads)``
    of the list, each tensor's ``head`` (values before its 16-byte body, or
    -1 for one value a unit) and the prefix sum of its blocks."""
    first: int
    heads: List[int]
    block_start: List[int]

    @property
    def blocks(self) -> int:
        return self.block_start[-1]


def _head(numel: int, addrs: Sequence[int]) -> int:
    """Values before the 16-byte body of a tensor whose arrays start at
    ``addrs``, or -1 where the arrays disagree modulo 16."""
    if len({a % 16 for a in addrs}) != 1:
        return -1
    return min((16 - addrs[0] % 16) % 16 // 4, numel)


def plan(numels: Sequence[int], addrs: Sequence[Sequence[int]]
         ) -> List[Launch]:
    """The launches for tensors of ``numels`` values whose arrays (p, g,
    m, v; no g where the gradient is zero) start at ``addrs``: at most
    :data:`MAX_TENSORS` tensors a launch, in order, each tensor
    ``ceil(units / UNITS_PER_BLOCK)`` blocks, at least one, and none for
    a tensor of 0 values."""
    launches = []
    for first in range(0, len(numels), MAX_TENSORS):
        heads, starts = [], [0]
        for n, a in zip(numels[first:first + MAX_TENSORS],
                        addrs[first:first + MAX_TENSORS]):
            h = _head(n, a)
            units = n if h < 0 else (n - h) // 4
            heads.append(h)
            blocks = max(1, -(-units // UNITS_PER_BLOCK)) if n else 0
            starts.append(starts[-1] + blocks)
        launches.append(Launch(first, heads, starts))
    return launches


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    if lib.gn_adamw.argtypes is None:
        lib.gn_adamw.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.gn_adamw.restype = ctypes.c_int
        if (lib.gn_adamw_table_bytes() != ctypes.sizeof(_Table)
                or lib.gn_adamw_max_tensors() != MAX_TENSORS
                or lib.gn_adamw_units_per_block() != UNITS_PER_BLOCK):
            raise RuntimeError("adamw: csrc/adamw.cu's table differs from "
                               "ops/kernels/adamw.py's")
    return lib


Tensors = Sequence[torch.Tensor]
Grads = Sequence[Optional[torch.Tensor]]
LR = Union[float, torch.Tensor]


def adamw_update_plain(params: Tensors, grads: Grads, exp_avgs: Tensors,
                       exp_avg_sqs: Tensors, steps: Tensors, *, lr: LR,
                       beta1: float, beta2: float, eps: float,
                       weight_decay: float) -> None:
    """The update in plain torch, in place, one tensor at a time, in the
    kernel's order."""
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        s.add_(1)
        step_size = 1 / ((torch.pow(beta1, s) - 1) / lr)
        bc2_sqrt = torch.sqrt(-(torch.pow(beta2, s) - 1))
        if g is None:
            g = torch.zeros_like(p)
        p.mul_(1 - lr * weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt + eps) / step_size)


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr
           ) -> Tuple[torch.device, List[int]]:
    dev = params[0].device
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)
            == len(steps)):
        raise ValueError("adamw: the lists differ in length")
    numels = []
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        for t in (p, m, v) if g is None else (p, g, m, v):
            if (t.device != dev or t.dtype != torch.float32
                    or t.layout != torch.strided or not t.is_contiguous()
                    or t.numel() != p.numel()):
                raise ValueError(f"adamw: every array must be a contiguous "
                                 f"f32 tensor of its parameter's size on "
                                 f"{dev}")
        if s.device != dev or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"adamw: step counts must be one f32 value on "
                             f"{dev}")
        if p.numel() >= _NUMEL_LIMIT:
            raise ValueError("adamw: a tensor of 2^31 values or more")
        numels.append(p.numel())
    if isinstance(lr, torch.Tensor) and (
            lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1):
        raise ValueError(f"adamw: a tensor rate must be one f32 value on "
                         f"{dev}")
    return dev, numels


def adamw_update(params: Tensors, grads: Grads, exp_avgs: Tensors,
                 exp_avg_sqs: Tensors, steps: Tensors, *, lr: LR,
                 beta1: float, beta2: float, eps: float,
                 weight_decay: float) -> int:
    """Update ``params`` and their moments in place from ``grads`` (``None``
    for a zero gradient) and advance ``steps`` (0-d f32 counts) on the
    current stream: one foreach add for the counts, then one launch a
    :data:`MAX_TENSORS` tensors (none for tensors of 0 values alone).
    ``lr`` is a float or a 0-d f32 tensor on the device, read when the
    kernel runs.  CPU tensors take :func:`adamw_update_plain`.  Returns
    the number of launches of the kernel."""
    global LAUNCHES
    if not params:
        return 0
    if params[0].device.type == "cpu":
        adamw_update_plain(params, grads, exp_avgs, exp_avg_sqs, steps,
                           lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                           weight_decay=weight_decay)
        return 0
    dev, numels = _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr)
    addrs = [[t.data_ptr() for t in ((p, m, v) if g is None else (p, g, m, v))]
             for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs)]
    tab = _Table()
    tensor_lr = isinstance(lr, torch.Tensor)
    tab.lr_ptr = lr.data_ptr() if tensor_lr else None
    tab.lr = 0.0 if tensor_lr else lr
    tab.decay = 1.0 if tensor_lr else 1 - lr * weight_decay
    tab.beta1, tab.beta2, tab.eps, tab.wd = beta1, beta2, eps, weight_decay
    tab.one_minus_beta1, tab.one_minus_beta2 = 1 - beta1, 1 - beta2
    torch._foreach_add_(list(steps), 1)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = [ln for ln in plan(numels, addrs) if ln.blocks]
    for ln in launches:
        n = len(ln.heads)
        sl = slice(ln.first, ln.first + n)
        tab.n = n
        tab.p[:n] = [t.data_ptr() for t in params[sl]]
        tab.g[:n] = [0 if t is None else t.data_ptr() for t in grads[sl]]
        tab.m[:n] = [t.data_ptr() for t in exp_avgs[sl]]
        tab.v[:n] = [t.data_ptr() for t in exp_avg_sqs[sl]]
        tab.step[:n] = [t.data_ptr() for t in steps[sl]]
        tab.numel[:n] = numels[sl]
        tab.block_start[:n + 1] = ln.block_start
        tab.head[:n] = ln.heads
        with torch.cuda.device(dev):
            err = lib.gn_adamw(ctypes.addressof(tab), ln.blocks, stream)
        _build.check(lib, err, "adamw")
        LAUNCHES += 1
    return len(launches)

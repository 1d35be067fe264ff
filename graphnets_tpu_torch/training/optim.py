"""The port's Adam and AdamW: torch's optimizers, whose ``step()`` runs
the whole update of every parameter as one hand-written kernel on the
card (``ops/kernels/adamw.py``, ``csrc/adamw.cu``).

:class:`FusedAdamW` and :class:`FusedAdam` subclass ``torch.optim.AdamW``
and ``torch.optim.Adam`` and keep their state (``step``, ``exp_avg``,
``exp_avg_sq`` a parameter, made at the first step), so ``state_dict``,
``load_state_dict`` and every reader of that state work unchanged.  On
CUDA parameters ``step()`` always takes the kernel: the kernel's wrapper
raises on a tensor it cannot update (another dtype, a sparse or strided
tensor, state or rate on another device), and ``step()`` on a group
option the kernel does not have (``amsgrad``, ``maximize``,
``differentiable``, ``fused``, tensor betas, Adam's coupled decay).  On
CPU parameters it is the parent's ``step()``.

On both a parameter with no gradient has a zero gradient: it is decayed
and its moments advance, as ``optax`` updates every parameter (torch's
own step skips it).  On the card its ``grad`` stays ``None``; on the CPU
``step()`` gives it a zero ``grad`` (left there) before the parent's
step.

``fused_steps`` and ``fused_tensors`` count the kernel path's calls and
the tensors they updated, ``fallback_steps`` the parent's calls; they
count always, as Python calls (a CUDA-graph replay runs no Python).  With
the tracing switch on the launches are the span
``gn.train.optimizer.fused``.
"""

from __future__ import annotations

import torch

from ..ops.kernels import adamw as kernel
from ..utils.profiling import span

__all__ = ["FusedAdamW", "FusedAdam"]

_NOT_IN_KERNEL = ("amsgrad", "maximize", "differentiable", "fused")


class _KernelStep:
    """The two paths of ``step()``, shared by both optimizers."""

    def _init_kernel_step(self) -> None:
        self.fused_steps = self.fused_tensors = self.fallback_steps = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if any(p.is_cuda for g in self.param_groups for p in g["params"]):
            self._kernel_step()
        else:
            self._parent_step()
        return loss

    def _parent_step(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        parent = super().step.__func__
        if getattr(parent, "hooked", False):
            # torch wraps a class's step with the step hooks once an
            # optimizer of that class is made; this call ran them.
            parent = parent.__wrapped__
        parent(self)
        self.fallback_steps += 1

    def _kernel_step(self) -> None:
        decoupled = isinstance(self, torch.optim.AdamW)
        with span("gn.train.optimizer.fused"):
            for group in self.param_groups:
                params = group["params"]
                if not params:
                    continue
                beta1, beta2 = group["betas"]
                refused = [k for k in _NOT_IN_KERNEL if group.get(k)]
                if group["weight_decay"] and not (
                        decoupled or group.get("decoupled_weight_decay")):
                    refused.append("coupled weight_decay")
                if isinstance(beta1, torch.Tensor) or isinstance(
                        beta2, torch.Tensor):
                    refused.append("tensor betas")
                if refused:
                    raise ValueError(f"{type(self).__name__}: the kernel "
                                     f"has no {', '.join(refused)}")
                for p in params:
                    st = self.state[p]
                    if not st:
                        # torch's lazy state of a capturable group.
                        st["step"] = torch.zeros((), dtype=torch.float32,
                                                 device=p.device)
                        st["exp_avg"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                        st["exp_avg_sq"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                states = [self.state[p] for p in params]
                kernel.adamw_update(
                    params, [p.grad for p in params],
                    [s["exp_avg"] for s in states],
                    [s["exp_avg_sq"] for s in states],
                    [s["step"] for s in states], lr=group["lr"],
                    beta1=beta1, beta2=beta2, eps=group["eps"],
                    weight_decay=group["weight_decay"])
                self.fused_tensors += len(params)
        self.fused_steps += 1


class FusedAdamW(_KernelStep, torch.optim.AdamW):
    """``torch.optim.AdamW`` whose step is one kernel on the card (see the
    module)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_kernel_step()


class FusedAdam(_KernelStep, torch.optim.Adam):
    """``torch.optim.Adam`` whose step is one kernel on the card (see the
    module); its update is AdamW's with no decay."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_kernel_step()

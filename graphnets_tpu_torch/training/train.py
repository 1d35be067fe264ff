"""The training step and the sort-task trainers (counterparts of
``graphnets_tpu/training/train.py``).

The model's parameters are the f32 master copy.  Each step runs the
forward on ``{name: p.to(compute_dtype)}`` through
``torch.func.functional_call``, so activations and the kernels run in the
compute dtype while the gradients come back through the cast in f32 (the
JAX headline step, ``benchmarks/bench_train_step.py:47-55``).  The
optimizer updates the masters in place, which JAX's functional step does
by returning new arrays.

:func:`train_sort` is the host loop of the sort example: batches from the
numpy generator, one step each.  :func:`train_sort_device` is the flagship
loop as the JAX package runs it by default: the batch is generated on the
device inside the captured step (``data/sort_task.device_batch``), so a
chunk of steps is a chunk of graph replays with one host sync, and
:func:`evaluate_sort` evaluates the same way.  :class:`TrainState` is what
a run carries from step to step, and what ``training/checkpoint`` saves.

:func:`make_node_classification_step` is the step of sampled training on a
large graph (``data/large_graph``): a device gather of the node features,
the seed nodes' masked cross-entropy, and the optimizer step.

:func:`capture_step` is the port's ``jax.jit(step, donate_argnums=0)``:
on the card it captures a step as a CUDA graph, one per input structure,
and replays it, so a step costs one graph launch on the host instead of a
Python walk over ~1,400 kernel launches.  It refuses to capture while the
debug checks (``utils/debug``) are on: they read tensors on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..data.sort_task import (SortTaskConfig, device_batch, get_batch,
                              sort_pad_spec)
from ..graph import GraphsTuple
from ..models.encode_process_decode import EncodeProcessDecode
from ..utils.config import (debug_checks, get_config, resolve_device,
                            use_kernels)
from ..utils.profiling import PhaseMarkers, span
from ..utils.tree import map_tensors, structure, tensors
from .losses import (graph_accuracy, graph_loss_nf_ef, masked_accuracy,
                     masked_logit_crossentropy)
from .optim import FusedAdam, FusedAdamW
from .schedules import LearningRate, follow_schedule, initial_lr

__all__ = ["adam", "adamw", "make_train_step",
           "make_node_classification_step", "capture_step", "CapturedStep",
           "TrainState", "train_sort", "SortTrainResult",
           "make_sort_device_step", "train_sort_device", "evaluate_sort"]


def _on_cuda(params) -> bool:
    return bool(params) and all(p.is_cuda for p in params)


def _device(params) -> torch.device:
    return params[0].device if params else torch.device("cpu")


def adamw(params: Iterable[torch.Tensor], lr: LearningRate = 3e-4
          ) -> FusedAdamW:
    """``optax.adamw(lr)`` in torch: betas (0.9, 0.999), eps 1e-8 and
    weight decay 1e-4 (torch's default decay is 1e-2).  On CUDA
    parameters it is ``capturable``, so :func:`capture_step` can take its
    update into a CUDA graph, and its step is one kernel launch
    (``training/optim``; torch's own step elsewhere).  ``lr`` is a float
    or a schedule (``training/schedules``), evaluated at each step's count
    as optax does."""
    params = list(params)
    return follow_schedule(FusedAdamW(
        params, lr=initial_lr(lr, _device(params)), betas=(0.9, 0.999),
        eps=1e-8, weight_decay=1e-4, capturable=_on_cuda(params)), lr)


def adam(params: Iterable[torch.Tensor], lr: LearningRate = 1e-3
         ) -> FusedAdam:
    """``optax.adam(lr)`` in torch: betas (0.9, 0.999), eps 1e-8;
    ``capturable`` on CUDA parameters, one kernel launch a step there, and
    ``lr`` a float or a schedule, as :func:`adamw`."""
    params = list(params)
    return follow_schedule(FusedAdam(
        params, lr=initial_lr(lr, _device(params)), betas=(0.9, 0.999),
        eps=1e-8, capturable=_on_cuda(params)), lr)


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[GraphsTuple, GraphsTuple], torch.Tensor]
        = graph_loss_nf_ef,
    training: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> Callable[[GraphsTuple, GraphsTuple], Dict[str, torch.Tensor]]:
    """Build ``step(x, y) -> metrics``: the loss of ``model`` on ``x``
    against ``y``, its backward, and one ``optimizer`` step on the
    model's parameters.

    ``compute_dtype`` (for example ``torch.bfloat16``) casts the
    parameters for the forward; ``None`` runs them as they are.
    ``generator`` draws the dropout masks.  The metrics are 0-d tensors on
    the model's device (no host sync): ``loss``, and where the prediction
    is a ``GraphsTuple`` its accuracies ``node_acc``, ``edge_acc`` and
    ``graph_acc`` (a regression model's prediction, as GraphCast's grid
    tensor, has none).

    With the tracing switch on (``utils/config.enable_tracing``) the step
    opens the spans ``gn.train.forward`` (parameter cast, model, loss),
    ``gn.train.backward``, ``gn.train.optimizer`` and ``gn.train.metrics``
    and puts a device marker before each and ``end`` after the last
    (``utils/profiling.PhaseMarkers``); inside another step body the
    outer body puts ``end``.
    """
    params = dict(model.named_parameters())
    mark = PhaseMarkers(_device(list(params.values())))

    def step(x: GraphsTuple, y: GraphsTuple) -> Dict[str, torch.Tensor]:
        with mark.step():
            mark("forward")
            with span("gn.train.forward"):
                optimizer.zero_grad(set_to_none=True)
                run = params if compute_dtype is None else {
                    n: p.to(compute_dtype) for n, p in params.items()}
                pred = functional_call(model, run, (x,), {
                    "training": training, "generator": generator})
                loss = loss_fn(pred, y)
            _backward_and_update(loss, params, optimizer, mark)
            with span("gn.train.metrics"), torch.no_grad():
                if not isinstance(pred, GraphsTuple):
                    return {"loss": loss.detach()}
                return {
                    "loss": loss.detach(),
                    "node_acc": masked_accuracy(pred.nf, y.nf, x.node_mask),
                    "edge_acc": masked_accuracy(pred.ef, y.ef, x.edge_mask),
                    "graph_acc": graph_accuracy(pred, y),
                }

    # What capture_step restores after its warm-up calls.
    step.model, step.optimizer = model, optimizer
    step.generators = () if generator is None else (generator,)
    return step


def _backward_and_update(loss: torch.Tensor, params: Dict[str, nn.Parameter],
                         optimizer: torch.optim.Optimizer,
                         mark: PhaseMarkers) -> None:
    """The backward and optimizer phases of a step body, and the marker
    of the metrics phase that follows them."""
    mark("backward")
    with span("gn.train.backward"):
        loss.backward()
    mark("optimizer")
    with span("gn.train.optimizer"):
        # A parameter the loss does not reach (the last core's graph
        # update) has a zero gradient in JAX, and optax still decays it
        # and advances its moments; torch would skip it.  The port's own
        # optimizers (training/optim) take a missing gradient as zero.
        if not isinstance(optimizer, (FusedAdamW, FusedAdam)):
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
    mark("metrics")


def make_node_classification_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    n_classes: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., torch.Tensor]:
    """Build ``step(graph, node_ids, labels, label_mask, seed_idx, feat) ->
    loss`` for sampled mini-batches of a large graph (the step of
    ``examples/node_classification.py`` and ``benchmarks/bench_arxiv.py``
    in the JAX package): the node features are gathered on the device from
    the resident table ``feat [N + 1, D]`` by the batch's ``node_ids``, the
    model runs under training, the logits of the seed nodes go through the
    masked cross-entropy against the one-hot ``labels``, and ``optimizer``
    takes one step on the model's parameters.

    ``compute_dtype`` casts the (f32 master) parameters for the forward,
    as in :func:`make_train_step`; ``feat`` is used in the type it has.
    The loss is a 0-d tensor on the model's device (no host sync).  The
    spans and markers are :func:`make_train_step`'s; the feature gather
    belongs to the forward."""
    params = dict(model.named_parameters())
    mark = PhaseMarkers(_device(list(params.values())))

    def step(graph: GraphsTuple, node_ids: torch.Tensor,
             labels: torch.Tensor, label_mask: torch.Tensor,
             seed_idx: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        with mark.step():
            mark("forward")
            with span("gn.train.forward"):
                optimizer.zero_grad(set_to_none=True)
                graph = graph.with_features(
                    nf=feat.index_select(0, node_ids))
                run = params if compute_dtype is None else {
                    n: p.to(compute_dtype) for n, p in params.items()}
                pred = functional_call(model, run, (graph,),
                                       {"training": True})
                logits = pred.nf.index_select(0, seed_idx)
                # jax.nn.one_hot: a label outside [0, n_classes) (an OGB
                # dataset's -1 for an unlabelled node) is a row of zeros.
                onehot = labels.long()[:, None] == torch.arange(
                    n_classes, device=labels.device)
                loss = masked_logit_crossentropy(logits, onehot, label_mask)
            _backward_and_update(loss, params, optimizer, mark)
            with span("gn.train.metrics"):
                return loss.detach()

    step.model, step.optimizer, step.generators = model, optimizer, ()
    return step


class CapturedStep:
    """A training step captured as CUDA graphs: the port's
    ``jax.jit(step, donate_argnums=0)`` (see :func:`capture_step`).

    ``step`` is a step built by :func:`make_train_step`,
    :func:`make_node_classification_step` or :func:`make_sort_device_step`.
    It carries what a call changes besides its outputs: its ``model`` and
    ``optimizer`` (either may be ``None``: an inference step has no
    optimizer), the ``generators`` it draws from and the ``buffers`` it
    writes in place (a device loop's metric sums).  The first call for a
    given input structure (every tensor's shape, dtype and device, the host
    metadata of a ``GraphsTuple``: ``homogeneous``, ``slot_shape``,
    ``pad_aliases_real``, ..., and the port's switches in ``utils/config``)
    warms the step up and captures it; later calls copy their inputs into
    the captured ones and replay.  That is one graph per bucket shape, as
    jit retraces, and every graph draws on one memory pool.  A step with no
    tensor inputs (one that makes its own batch) runs where its model,
    buffers and generators live.

    The warm-up runs ``WARMUP_CALLS`` steps on a side stream: they build
    the kernel libraries, open ``libcuda`` for the TMA descriptors'
    ``cuTensorMapEncodeTiled`` and grow the sorted sum's counters, work
    that belongs outside a capture.  Then the parameters, the optimizer's
    state (its step counts too), the generators and the buffers are put
    back as they were before the warm-up, so no warm-up step counts.  The
    capture runs under ``capture_error_mode="global"``; a refused call
    raises, and nothing falls back to eager on the card.  With the debug
    checks on (``GRAPHNETS_TPU_TORCH_DEBUG=1``) it refuses to capture: they
    read tensors on the host, which a capture cannot.  A step on the CPU
    runs eagerly: the caller asked for the CPU.

    The generators are registered with every graph, so each replay draws
    fresh numbers, the sequence eager calls would draw.  Outputs are fresh
    tensors, as jit's are.  After a replay the parameters and the
    optimizer's state hold the step's update; the parameters' ``.grad``
    belong to the graph and are not the step's output.  The optimizer must
    be ``Adam`` or ``AdamW``: their fresh state is all zeros, which is what
    the restore writes into the state the warm-up created
    (``capturable=True`` on CUDA, as :func:`adam` and :func:`adamw` make
    it).

    ``captures``, ``replays`` and ``traced_calls`` (eager calls of the step
    itself: warm-ups and captures, the calls that pass through the kernel
    wrappers' launch counters) count what happened; ``copy_in_bytes`` and
    ``copy_in_tensors`` count the copies of inputs into the captured ones
    that calls on the card made (an input that is the captured tensor
    itself is not copied).  All five count always.

    The tracing switch (``GRAPHNETS_TPU_TORCH_TRACE=1``,
    ``utils/config.enable_tracing``) is one of the switches in the key, so
    toggling it captures anew.  While it is on a call opens the spans
    ``gn.step`` and, inside it, ``gn.step.lookup``, ``gn.step.copy_in``,
    ``gn.step.replay`` and ``gn.step.outputs`` (``gn.step.capture`` and
    its ``gn.step.warm_up`` where it captures), and the step's device
    phase markers (``utils/profiling.PhaseMarkers``) are captured with it:
    only a graph captured with the switch on holds them.
    """

    WARMUP_CALLS = 2

    def __init__(self, step: Callable):
        self.step = step
        self.model: Optional[nn.Module] = getattr(step, "model", None)
        self.optimizer: Optional[torch.optim.Optimizer] = getattr(
            step, "optimizer", None)
        self.generators = tuple(getattr(step, "generators", ()))
        self.buffers = tuple(getattr(step, "buffers", ()))
        if self.optimizer is not None and not isinstance(
                self.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
            raise TypeError("capture_step restores Adam / AdamW state only, "
                            f"got {type(self.optimizer).__name__}")
        self._graphs: Dict[Any, Tuple] = {}
        self._pool = None
        self.captures = self.replays = self.traced_calls = 0
        self.copy_in_bytes = self.copy_in_tensors = 0

    def _params(self):
        return [] if self.model is None else list(self.model.parameters())

    def _on_card(self, flat) -> bool:
        if flat:
            if not any(t.is_cuda for t in flat):
                return False
            if not all(t.is_cuda for t in flat):
                raise ValueError("capture_step: the inputs mix CPU and CUDA "
                                 "tensors")
            return True
        # No tensor inputs: the step runs where its state lives.
        return (any(t.is_cuda for t in self._params() + list(self.buffers))
                or any(g.device.type == "cuda" for g in self.generators))

    def _key(self, args) -> Tuple:
        """The key of the graph a call on ``args`` replays: the input
        structure and the port's switches, the "auto" kernel switch
        resolved first (the step would resolve it, and a key read before
        that would miss on every later call, capturing the step twice)."""
        use_kernels()
        return structure(args), dataclasses.astuple(get_config())

    def __call__(self, *args):
        with span("gn.step"):
            with span("gn.step.lookup"):
                flat = tensors(args)
                eager = not self._on_card(flat)
                if not eager:
                    key = self._key(args)
                    entry = self._graphs.get(key)
            if eager:
                return self.step(*args)
            if entry is None:
                entry = self._graphs[key] = self._capture(args)
            graph, static_in, sizes, static_out = entry
            with span("gn.step.copy_in"):
                n_bytes = n_tensors = 0
                for dst, src, size in zip(static_in, flat, sizes):
                    if dst.data_ptr() != src.data_ptr():
                        dst.copy_(src)
                        n_bytes += size
                        n_tensors += 1
                self.copy_in_bytes += n_bytes
                self.copy_in_tensors += n_tensors
            with span("gn.step.replay"):
                graph.replay()
            self.replays += 1
            with span("gn.step.outputs"):
                return map_tensors(lambda t: t.clone(), static_out)

    def clear(self) -> None:
        """Drop every captured graph and their memory pool, as
        ``jax.clear_caches()`` drops jit's compiled steps: the next call
        captures anew.  A caller that will not replay a graph again (one
        captured under other switches) frees its pool for the next
        capture this way."""
        self._graphs.clear()
        self._pool = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _snapshot(self):
        params = [p.detach().clone() for p in self._params()]
        opt = self.optimizer
        state = {} if opt is None else {
            p: {k: v.clone() for k, v in opt.state[p].items()}
            for group in opt.param_groups for p in group["params"]
            if opt.state.get(p)}
        gens = [g.get_state() for g in self.generators]
        bufs = [b.clone() for b in self.buffers]
        return params, state, gens, bufs

    def _restore(self, snap) -> None:
        """Put back what :meth:`_snapshot` saw, in place (the captured
        graph keeps the addresses).  State the warm-up created is zeroed:
        a fresh Adam / AdamW state."""
        params, state, gens, bufs = snap
        with torch.no_grad():
            for p, saved in zip(self._params(), params):
                p.copy_(saved)
            if self.optimizer is not None:
                for p, st in self.optimizer.state.items():
                    for k, v in st.items():
                        if p in state:
                            v.copy_(state[p][k])
                        else:
                            v.zero_()
            for b, saved in zip(self.buffers, bufs):
                b.copy_(saved)
        for g, s in zip(self.generators, gens):
            g.set_state(s)

    def warm_up(self, *args) -> None:
        """``WARMUP_CALLS`` eager steps on ``args`` (on a side stream on the
        card), then the parameters, the optimizer's state, the generators
        and the buffers as they were before."""
        with span("gn.step.warm_up"):
            snap = self._snapshot()
            side = None
            if self._on_card(tensors(args)):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                for _ in range(self.WARMUP_CALLS):
                    self.step(*args)
                    self.traced_calls += 1
            if side is not None:
                torch.cuda.current_stream().wait_stream(side)
            self._restore(snap)

    def _capture(self, args) -> Tuple:
        if debug_checks():
            raise RuntimeError(
                "capture_step: the debug checks are on "
                "(GRAPHNETS_TPU_TORCH_DEBUG=1 or enable_debug_checks()); "
                "they read tensors on the host, which a CUDA-graph capture "
                "cannot. Turn them off to capture, or call the step itself "
                "(uncaptured) to run it with the checks.")
        with span("gn.step.capture"):
            static_args = map_tensors(lambda t: t.clone(), args)
            self.warm_up(*static_args)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                if g.device.type == "cuda":
                    graph.register_generator_state(g)
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="global"):
                static_out = self.step(*static_args)
            self.traced_calls += 1
            self.captures += 1
        static_in = tensors(static_args)
        return (graph, static_in, [t.numel() * t.element_size()
                                   for t in static_in], static_out)


def capture_step(step: Callable) -> CapturedStep:
    """``step`` captured as CUDA graphs and replayed (:class:`CapturedStep`),
    the counterpart of ``jax.jit(step, donate_argnums=0)``: the parameters
    and the optimizer's state are updated in place, as donation lets XLA
    do.  On CPU tensors the step runs eagerly."""
    return CapturedStep(step)


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the JAX package's
    ``TrainState`` (params, opt_state, step, rng) as the ``model`` (it
    holds the parameters), the ``optimizer`` (its state), the ``step``
    count and the ``generators`` the steps draw from.  The model, the
    optimizer and the generators are updated in place; ``step`` is a host
    integer.  ``training/checkpoint`` saves and restores all four."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generators: Tuple[torch.Generator, ...] = ()


@dataclasses.dataclass
class SortTrainResult:
    """The trained ``model`` (it holds the parameters), its ``optimizer``
    (the AdamW moments), the last step's or chunk's ``metrics`` as floats,
    the throughput without the first step or chunk, the step itself (a
    :class:`CapturedStep`, to go on training) and the :class:`TrainState`
    to save or resume from."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    metrics: dict
    steps_per_sec: float
    step: Optional[Callable] = None
    state: Optional[TrainState] = None


def _sort_model(cfg: SortTaskConfig, core_dims, n_cores: int, seed: int,
                device) -> nn.Module:
    """The reference's sort model, ``(0, vocab, 0) -> core_dims -> (2, 2,
    0)``, initialised from a host generator seeded ``seed``."""
    return EncodeProcessDecode(
        x_dims=(0, cfg.vocab_size, 0), core_dims=core_dims,
        y_dims=(2, 2, 0), n_cores=n_cores, device=device,
        generator=torch.Generator().manual_seed(seed))


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_sort(
    steps: int = 1000,
    cfg: SortTaskConfig = SortTaskConfig(),
    core_dims: Tuple[int, int, int] = (384, 384, 384),
    n_cores: int = 2,
    learning_rate: LearningRate = 3e-4,
    seed: int = 0,
    log_every: int = 0,
    model: Optional[nn.Module] = None,
    device=None,
) -> SortTrainResult:
    """Train the sort model in f32: encoder ``(0, vocab, 0) -> core_dims``,
    ``n_cores`` GNCores, decoder to ``(2, 2, 0)``, AdamW
    (``learning_rate``: a float or a schedule), on batches from
    the host generator seeded with ``seed``.  Runs on ``device`` (``cuda``
    unless the caller passes another); a ``model`` passed in must already
    live there.  The step goes through :func:`capture_step` (eager on the
    CPU).  The first step (kernel builds, warm-up, capture) is left out of
    ``steps_per_sec``."""
    device = resolve_device(device)
    if model is None:
        model = _sort_model(cfg, core_dims, n_cores, seed, device)
    optimizer = adamw(model.parameters(), learning_rate)
    # On the card the step is captured and replayed, as JAX's jit.
    step_fn = capture_step(make_train_step(model, optimizer))

    rng = np.random.default_rng(seed)
    pad = sort_pad_spec(cfg)
    metrics: Dict[str, torch.Tensor] = {}
    t0 = None
    for i in range(steps):
        x, y = get_batch(rng, cfg, pad, device=device)
        metrics = step_fn(x, y)
        if i == 0:
            _wait(device)
            t0 = time.perf_counter()
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: " + ", ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()))
    _wait(device)
    dt = (time.perf_counter() - t0) if steps > 1 else float("inf")
    return SortTrainResult(
        model=model, optimizer=optimizer,
        metrics={k: float(v) for k, v in metrics.items()},
        steps_per_sec=(steps - 1) / dt if steps > 1 else 0.0, step=step_fn,
        state=TrainState(model, optimizer, steps))


_METRICS = ("loss", "node_acc", "edge_acc", "graph_acc")


def make_sort_device_step(state: TrainState, cfg: SortTaskConfig,
                          pad=None, dtype: Optional[torch.dtype] = None
                          ) -> Callable[[], None]:
    """The body of :func:`train_sort_device`'s loop, the counterpart of the
    JAX loop's ``lax.scan`` body: ``step()`` draws a batch on the device
    from ``state.generators[0]`` (``device_batch``, features in ``dtype``),
    takes one :func:`make_train_step` step of ``state.model`` and
    ``state.optimizer`` on it, and adds the step's metrics into
    ``step.sums`` (0-d tensors on the device, by name), so that a chunk of
    steps syncs the host once.  The same generator draws any dropout masks.

    In bf16 the parameters stay the f32 masters and are not cast as a
    whole: the batch's features are bf16 and each layer casts at use, as
    the JAX model does (``Linear`` casts its weight to the input's type;
    ``LayerNorm`` computes in f32 with f32 scale and bias).

    With the tracing switch on, the draw is the span ``gn.train.batch``
    behind the ``batch`` marker, the step's phases are
    :func:`make_train_step`'s, the sums join its metrics phase, and the
    ``end`` marker closes the step."""
    gen = state.generators[0]
    core = make_train_step(state.model, state.optimizer, generator=gen)
    mark = PhaseMarkers(gen.device)
    sums = {k: torch.zeros((), dtype=torch.float32, device=gen.device)
            for k in _METRICS}

    def step() -> None:
        with mark.step():
            mark("batch")
            with span("gn.train.batch"):
                x, y = device_batch(gen, cfg, pad, dtype)
            metrics = core(x, y)
            with span("gn.train.metrics"):
                for k, v in sums.items():
                    v.add_(metrics[k])

    step.model, step.optimizer = state.model, state.optimizer
    step.generators, step.sums = (gen,), sums
    step.buffers = tuple(sums.values())
    return step


def _split_seed(seed: int) -> int:
    """A seed for the batch generator that differs from the model init's
    stream (as JAX splits one key into two)."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])


def train_sort_device(
    steps: int = 20_000,
    cfg: SortTaskConfig = SortTaskConfig(),
    core_dims: Tuple[int, int, int] = (384, 384, 384),
    n_cores: int = 2,
    learning_rate: LearningRate = 3e-4,
    seed: int = 0,
    chunk: int = 500,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    dtype: Optional[torch.dtype] = None,
    model: Optional[nn.Module] = None,
    eval_batches: int = 256,
    uniform: bool = False,
    device=None,
    state: Optional[TrainState] = None,
) -> SortTrainResult:
    """The flagship recipe with the whole loop on the device, as the JAX
    package runs it by default: the batch is generated inside the step
    (``device_batch``) and the step is captured as a CUDA graph
    (:func:`capture_step`; eager on the CPU), so a chunk of ``chunk`` steps
    is ``chunk`` graph replays.  The metrics are summed on the device and
    the host syncs once a chunk, for the chunk's mean (``log_fn(step,
    metrics)`` after each chunk; the last chunk's mean in the result).
    Whole chunks run: ``steps`` rounds up to a multiple of ``chunk``.
    ``steps_per_sec`` leaves out the first chunk (kernel builds, warm-up,
    capture).

    ``dtype`` is the batches' type (``torch.bfloat16`` for bf16 compute;
    the parameters stay f32, see :func:`make_sort_device_step`).
    ``uniform=True`` lays the batches out in uniform slots
    (``sort_pad_spec(cfg, uniform=True)``).  The model is
    ``EncodeProcessDecode((0, vocab, 0) -> core_dims -> (2, 2, 0))`` with
    ``n_cores`` cores, initialised from ``seed`` unless ``model`` is given,
    trained by AdamW(``learning_rate``, a float or a schedule) on
    ``device`` (``cuda`` unless the caller passes another); the batches
    come from a generator there, seeded from ``seed``.  ``state`` resumes
    a run instead (its model, optimizer, step count and generator, for
    example restored from a checkpoint; ``model``, ``seed`` and
    ``learning_rate`` are then unused; a scheduled optimizer goes on from
    its own step count).
    ``eval_batches`` is unused, as in the JAX package."""
    if state is None:
        device = resolve_device(device)
        if model is None:
            model = _sort_model(cfg, core_dims, n_cores, seed, device)
        state = TrainState(
            model, adamw(model.parameters(), learning_rate), 0,
            (torch.Generator(device=device).manual_seed(_split_seed(seed)),))
    device = state.generators[0].device
    step = make_sort_device_step(state, cfg, sort_pad_spec(cfg, uniform),
                                 dtype)
    step_fn = capture_step(step)
    sums = list(step.sums.values())

    metrics: Dict[str, float] = {}
    t0, done, first_done = None, 0, 0
    while done < steps:
        for v in sums:
            v.zero_()
        for _ in range(chunk):
            step_fn()
        done += chunk
        state.step += chunk
        # One host sync a chunk: the chunk's mean metrics.
        means = (torch.stack(sums) / chunk).tolist()
        metrics = dict(zip(step.sums, means))
        if t0 is None:
            _wait(device)
            t0, first_done = time.perf_counter(), done
        if log_fn is not None:
            log_fn(state.step, metrics)
    _wait(device)
    dt = time.perf_counter() - t0 if steps > chunk else float("inf")
    sps = (done - first_done) / dt if done > first_done else 0.0
    return SortTrainResult(model=state.model, optimizer=state.optimizer,
                           metrics=metrics, steps_per_sec=sps, step=step_fn,
                           state=state)


def evaluate_sort(model: nn.Module, cfg: SortTaskConfig,
                  n_batches: int = 256, seed: int = 1234,
                  dtype: Optional[torch.dtype] = None,
                  uniform: bool = False) -> Dict[str, float]:
    """Task accuracy on fresh batches generated on the model's device from
    a generator seeded ``seed``: a captured forward replayed ``n_batches``
    times (eager on the CPU), the accuracies summed on the device and read
    once.  Returns the mean node, edge and graph accuracy over the batches;
    ``graph_acc`` is the flagship criterion (every node AND edge of a graph
    right)."""
    pad = sort_pad_spec(cfg, uniform=uniform)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    sums = torch.zeros(3, dtype=torch.float32, device=device)

    def step() -> None:
        x, y = device_batch(gen, cfg, pad, dtype)
        with torch.no_grad():
            pred = model(x)
            sums.add_(torch.stack([
                masked_accuracy(pred.nf, y.nf, x.node_mask),
                masked_accuracy(pred.ef, y.ef, x.edge_mask),
                graph_accuracy(pred, y)]))

    step.model, step.generators, step.buffers = model, (gen,), (sums,)
    run = capture_step(step)
    for _ in range(n_batches):
        run()
    node, edge, graph = (sums / n_batches).tolist()
    return {"node_acc": node, "edge_acc": edge, "graph_acc": graph}

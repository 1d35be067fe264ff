"""The port's one-launch AdamW / Adam (``training/optim.py``,
``ops/kernels/adamw.py``, ``csrc/adamw.cu``).

On the CPU: ``pt.adamw`` / ``pt.adam`` take torch's own step and give
its results to the bit over 5 steps (a float rate and a schedule's tensor
rate, a parameter the loss does not reach, a 0-element parameter), a
missing gradient as zero also when ``step()`` is called directly; the
plain update against torch's; the launch plan at the 4 KB argument limit.
(``tests/test_torch_train.py`` holds the optimizer and the plain update,
a missing gradient included, against ``optax.adamw``.)

On the card (marked ``cuda``; skipped without one): the kernel against
torch's capturable foreach AdamW / Adam over 10 steps on the sort model's
72 tensors, and against the plain update on misaligned views of one
buffer; a captured replay against the eager kernel, to the bit; the
``state_dict`` through ``training/checkpoint``; a train step on the card
against the same step on the CPU, a leaf the loss does not reach
included; a tensor or an option the kernel cannot take raises.  Tolerance: each tensor's
largest difference within 4 f32 ulps (4 x 2^-23) of its largest
magnitude: the kernel's f32 operations are torch's, one for one, but
inside one of torch's passes (the lerp, the addcmul) a multiply and an
add may be contracted into one rounding on one side and not the other,
and torch may take b^t in another precision (1.3 ulps after 10 steps on
an H100).

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_adamw_kernel.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.ops.kernels import adamw as ak
from graphnets_tpu_torch.training import optim
from graphnets_tpu_torch.training.schedules import (
    follow_schedule, initial_lr, warmup_cosine_decay_schedule)
from graphnets_tpu_torch.training.train import _backward_and_update
from graphnets_tpu_torch.utils.profiling import PhaseMarkers

ULPS = 4 * 2.0 ** -23
SCHEDULE = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _params(device, shapes=((5, 3), (7,), (0, 4), (2, 2)), seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=gen).to(device))
            for s in shapes]


def _torch_opt(kind, params, lr, capturable=False, foreach=None):
    """torch's optimizer as ``pt.adamw`` / ``pt.adam`` configure it."""
    cls = torch.optim.AdamW if kind == "adamw" else torch.optim.Adam
    extra = {"weight_decay": 1e-4} if kind == "adamw" else {}
    return follow_schedule(cls(
        params, lr=initial_lr(lr, params[0].device), betas=(0.9, 0.999),
        eps=1e-8, capturable=capturable, foreach=foreach, **extra), lr)


def _close(got, want, what):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    assert diff <= ULPS * scale, (what, diff, scale)


@pytest.mark.parametrize("kind", ["adamw", "adam"])
@pytest.mark.parametrize("rate", ["float", "schedule"])
def test_fallback_is_torch_to_the_bit(kind, rate):
    """On the CPU the port's optimizer is torch's step: 5 steps through
    the step body's backward-and-update, the 0-element parameter and one
    the loss never reaches (given a zero gradient, so decayed and its
    moments advanced) included, equal torch's optimizer after the same
    zero-gradient loop, to the bit."""
    lr = 3e-3 if rate == "float" else SCHEDULE
    mine, ref = _params("cpu"), _params("cpu")
    opt = (pt.adamw if kind == "adamw" else pt.adam)(mine, lr)
    assert isinstance(opt, torch.optim.AdamW if kind == "adamw"
                      else torch.optim.Adam)
    ropt = _torch_opt(kind, ref, lr)
    mark = PhaseMarkers("cpu")
    rng = np.random.default_rng(1)
    for _ in range(5):
        c = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for p in mine]
        # The loss reaches every parameter but the last.
        loss = lambda ps: sum(((p * w) ** 2).sum()
                              for p, w in zip(ps[:-1], c))
        opt.zero_grad(set_to_none=True)
        _backward_and_update(loss(mine), dict(enumerate(mine)), opt, mark)
        ropt.zero_grad(set_to_none=True)
        loss(ref).backward()
        for p in ref:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ropt.step()
    assert (opt.fallback_steps, opt.fused_steps, opt.fused_tensors) == \
        (5, 0, 0)
    for p, r in zip(mine, ref):
        assert torch.equal(p, r)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], ropt.state[r][k]), k
    unreached = mine[-1]
    assert not torch.equal(unreached, _params("cpu")[-1]) or kind == "adam"
    assert float(opt.state[unreached]["step"]) == 5


def test_fallback_takes_a_missing_gradient_as_zero():
    """Called directly (no step body), the CPU path takes a parameter with
    no gradient as one with a zero gradient, as the kernel does: equal to
    torch's AdamW given zeros, to the bit, over 3 steps."""
    mine, ref = _params("cpu"), _params("cpu")
    opt, ropt = pt.adamw(mine, 1e-2), _torch_opt("adamw", ref, 1e-2)
    for _ in range(3):
        for p, r in zip(mine, ref):
            p.grad = None
            r.grad = torch.zeros_like(r)
        mine[0].grad = torch.ones_like(mine[0])
        ref[0].grad = torch.ones_like(ref[0])
        opt.step()
        ropt.step()
    for p, r in zip(mine, ref):
        assert torch.equal(p, r)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], ropt.state[r][k]), k
    assert float(opt.state[mine[1]]["step"]) == 3
    assert not torch.equal(mine[1], _params("cpu")[1])


@pytest.mark.parametrize("rate", ["float", "tensor"])
def test_plain_update_matches_torch(rate):
    """The kernel's plain version against torch's AdamW on the CPU over 5
    steps (a missing gradient as zero; torch's single-tensor CPU path
    takes its bias corrections in double, so within ULPS)."""
    mine, ref = _params("cpu"), _params("cpu")
    lr = 3e-3 if rate == "float" else torch.tensor(3e-3)
    ropt = torch.optim.AdamW(ref, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    m = [torch.zeros_like(p) for p in mine]
    v = [torch.zeros_like(p) for p in mine]
    steps = [torch.zeros(()) for _ in mine]
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for _ in range(5):
            grads = [torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)) for p in mine[:-1]] + [None]
            assert ak.adamw_update(mine, grads, m, v, steps, lr=lr,
                                   beta1=0.9, beta2=0.999, eps=1e-8,
                                   weight_decay=1e-4) == 0
            for r, g in zip(ref, grads):
                r.grad = torch.zeros_like(r) if g is None else g.clone()
            ropt.step()
    for p, r, mm, vv, s in zip(mine, ref, m, v, steps):
        _close(p, r, "p")
        _close(mm, ropt.state[r]["exp_avg"], "exp_avg")
        _close(vv, ropt.state[r]["exp_avg_sq"], "exp_avg_sq")
        assert float(s) == 5


def test_plan_splits_at_the_argument_limit():
    """The table fits the 4 KB of kernel arguments; a list longer than
    MAX_TENSORS takes one launch a MAX_TENSORS tensors, in order; blocks
    follow the element count (16-byte units where the four arrays agree
    modulo 16, single values where not), at least one a tensor of values
    and none a tensor of 0 values."""
    assert ctypes.sizeof(ak._Table) <= 4096
    for count, sizes in ((72, [72]), (80, [80]), (81, [80, 1]),
                         (90, [80, 10]), (161, [80, 80, 1])):
        got = ak.plan([4] * count, [(256, 512, 768, 1024)] * count)
        assert [len(ln.heads) for ln in got] == sizes
        assert [ln.first for ln in got] == [
            80 * i for i in range(len(sizes))]
        assert all(ln.block_start == list(range(len(ln.heads) + 1))
                   for ln in got)
    u = ak.UNITS_PER_BLOCK
    (ln,) = ak.plan(
        [589824, 2, 0, 4 * u + 5, 4 * u + 5, u + 1, 7],
        [(0, 0, 0, 0), (16, 32, 48, 64), (0, 0, 0, 0), (4, 20, 36, 52),
         (4, 24, 36, 52), (8, 8, 8), (12, 28, 44, 60)])
    # 147,456 units in 144 blocks; 2 values of tail; no block; a head of 3,
    # u units and 2 values of tail; single values where the gradient's
    # address disagrees (4u + 5 units, 5 blocks); no gradient, a head of 2
    # and (u - 1) // 4 units; a head of 1, one unit and 2 of tail.
    assert ln.heads == [0, 0, 0, 3, -1, 2, 1]
    assert ln.block_start == [0, 144, 145, 145, 146, 151, 152, 153]
    assert ln.blocks == 153
    (ln,) = ak.plan([0, 0], [(0, 0, 0, 0)] * 2)
    assert ln.blocks == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rate", [("adamw", "float"),
                                       ("adamw", "schedule"),
                                       ("adam", "float")])
def test_kernel_matches_foreach_on_the_sort_model(cuda, kind, rate):
    """The port's optimizer on the sort model's 72 tensors (two of 0
    values) takes one launch a step, and after 10 steps with random
    gradients (none for two tensors: zeros for torch) equals torch's
    capturable foreach optimizer within ULPS, step counts exactly."""
    lr = 3e-4 if rate == "float" else SCHEDULE

    def model():
        return pt.EncodeProcessDecode(
            (0, 100, 0), (384,) * 3, (2, 2, 0), n_cores=2, device=cuda,
            generator=torch.Generator().manual_seed(0))
    mine, ref = list(model().parameters()), list(model().parameters())
    assert len(mine) == 72
    opt = (pt.adamw if kind == "adamw" else pt.adam)(mine, lr)
    ropt = _torch_opt(kind, ref, lr, capturable=True, foreach=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = ak.LAUNCHES
    for i in range(10):
        for j, (p, r) in enumerate(zip(mine, ref)):
            g = torch.randn(p.shape, generator=gen, device=cuda)
            p.grad = None if j in (5, 40) else g
            r.grad = torch.zeros_like(g) if j in (5, 40) else g.clone()
        opt.step()
        ropt.step()
    torch.cuda.synchronize()
    assert ak.LAUNCHES == before + 10
    assert (opt.fused_steps, opt.fused_tensors, opt.fallback_steps) == \
        (10, 720, 0)
    for p, r in zip(mine, ref):
        _close(p, r, "p")
        st, rst = opt.state[p], ropt.state[r]
        _close(st["exp_avg"], rst["exp_avg"], "exp_avg")
        _close(st["exp_avg_sq"], rst["exp_avg_sq"], "exp_avg_sq")
        assert float(st["step"]) == float(rst["step"]) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", ["same", "differ"])
def test_kernel_on_misaligned_views(cuda, offsets):
    """Views of one buffer at every offset modulo 16 bytes and sizes
    around a block's and a vector's edges: where the four arrays agree
    modulo 16 the 16-byte body with scalar head and tail, where they do
    not single values; within ULPS of the plain update after 10 steps,
    and 90 tensors take two launches a step."""
    u = ak.UNITS_PER_BLOCK
    sizes = ([1, 2, 3, 4, 5, 7, 4 * u - 1, 4 * u, 4 * u + 3, u + 1,
              3 * 4 * u + 9, 0] * 8)[:90]
    total = sum(sizes) + 4 * len(sizes) + 16
    gen = torch.Generator(device=cuda).manual_seed(4)
    bufs = {k: torch.randn(total, generator=gen, device=cuda)
            for k in "pgmv"}
    bufs["v"].abs_()
    views = {k: [] for k in "pgmv"}
    off = {k: 0 for k in "pgmv"}
    for i, n in enumerate(sizes):
        for j, k in enumerate("pgmv"):
            shift = i % 4 if offsets == "same" else (i + j) % 4
            off[k] += shift
            views[k].append(bufs[k][off[k]:off[k] + n])
            off[k] += n
    steps = [torch.zeros((), device=cuda) for _ in sizes]
    ref = {k: [t.clone() for t in ts] for k, ts in views.items()}
    rsteps = [s.clone() for s in steps]
    args = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=1e-4)
    before = ak.LAUNCHES
    for _ in range(10):
        assert ak.adamw_update(views["p"], views["g"], views["m"],
                               views["v"], steps, **args) == 2
        ak.adamw_update_plain(ref["p"], ref["g"], ref["m"], ref["v"],
                              rsteps, **args)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == before + 20
    for k in "pmv":
        for got, want in zip(views[k], ref[k]):
            _close(got, want, k)
    assert all(float(s) == 10 for s in steps)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", ["float", "tensor"])
def test_captured_replay_equals_the_eager_kernel(cuda, rate):
    """Three replays of a graph that captured the update equal three
    eager launches, to the bit; a tensor rate is read at each replay."""
    def state():
        gen = torch.Generator(device=cuda).manual_seed(5)
        mk = lambda n: torch.randn(n, generator=gen, device=cuda)
        sizes = [589824, 384, 2, 0, 1536 * 384 + 3]
        return ([mk(n) for n in sizes], [mk(n) for n in sizes],
                [mk(n) for n in sizes], [mk(n).abs() for n in sizes],
                [torch.zeros((), device=cuda) for _ in sizes])
    lr = 1e-3 if rate == "float" else torch.full((), 1e-3, device=cuda)
    args = dict(lr=lr, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-4)
    eager, graphed = state(), state()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ak.adamw_update(*graphed, **args)
    for i in range(3):
        if rate == "tensor":
            lr.fill_(1e-3 * (i + 1))
        ak.adamw_update(*eager, **args)
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, graphed):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert float(eager[4][0]) == 3


@pytest.mark.cuda
def test_state_dict_round_trips_through_checkpoint(cuda, tmp_path):
    """3 kernel steps, a checkpoint, a restore into a fresh model and
    optimizer, then 2 more steps on both: equal to the bit."""
    from graphnets_tpu_torch.training import checkpoint

    def run(opt, params, seeds):
        for s in seeds:
            gen = torch.Generator(device=cuda).manual_seed(s)
            for p in params:
                p.grad = torch.randn(p.shape, generator=gen, device=cuda)
            opt.step()
    params = _params(cuda, seed=6)
    opt = pt.adamw(params, SCHEDULE)
    run(opt, params, range(3))
    state = {"params": params, "opt": opt}
    checkpoint.save_checkpoint(str(tmp_path), 3, state)
    fresh = _params(cuda, seed=7)
    fopt = pt.adamw(fresh, SCHEDULE)
    checkpoint.restore_checkpoint(str(tmp_path), {"params": fresh,
                                                  "opt": fopt})
    assert isinstance(fopt, optim.FusedAdamW)
    run(opt, params, range(3, 5))
    run(fopt, fresh, range(3, 5))
    torch.cuda.synchronize()
    assert (fopt.fused_steps, fopt.fallback_steps) == (2, 0)
    for p, q in zip(params, fresh):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], fopt.state[q][k])


def _core_batches(device, d, seed=8):
    """Three graphs of 8 nodes as a padded batch on ``device``, with
    targets; the same numbers on every device."""
    rng = np.random.default_rng(seed)
    adjs = [(rng.random((8, 8)) < 0.3).astype(np.int64) for _ in range(3)]
    normal = lambda *s: rng.normal(size=s).astype(np.float32)
    data = {"graphs": adjs, "ef": [normal(int(a.sum()), d) for a in adjs],
            "nf": [normal(8, d) for _ in adjs], "gf": normal(3, d)}
    pad = pt.PadSpec.uniform(10, max(int(a.sum()) for a in adjs) + 8)
    x = pt.batch(data, pad=pad, device=device)
    y = x.with_features(ef=torch.from_numpy(normal(*x.ef.shape)).to(device),
                        nf=torch.from_numpy(normal(*x.nf.shape)).to(device),
                        gf=None)
    return x, y


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three ``make_train_step`` steps of two f32 GNCores with
    ``pt.adamw``: the kernel on the card against torch's step on the CPU
    (which tests/test_torch_train.py holds against optax).  The second
    core's graph update, which the loss does not reach, has a zero
    gradient on both: its moments stay 0, its step count is 3 and it is
    decayed, within ULPS of p (1 - lr wd)^3; the other parameters within
    2 lr a step (a gradient near 0 may flip the sign of Adam's early
    steps, whose size is about lr)."""
    d, lr, steps = 16, 1e-3, 3
    params, states, counts = [], [], []
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(0)
        model = pt.GNCoreList([pt.GNCore((d,) * 3, device=dev, generator=gen)
                               for _ in range(2)])
        p0 = [p.detach().cpu().clone() for p in model.parameters()]
        opt = pt.adamw(model.parameters(), lr)
        step = pt.make_train_step(model, opt)
        x, y = _core_batches(dev, d)
        for _ in range(steps):
            step(x, y)
        params.append([p.detach().cpu() for p in model.parameters()])
        states.append([{k: v.cpu() for k, v in opt.state[p].items()}
                       for p in model.parameters()])
        counts.append((opt.fused_steps, opt.fallback_steps))
    assert counts == [(0, steps), (steps, 0)]
    unreached = 0
    for p, q, sp, sq, w in zip(*params, *states, p0):
        assert float(sp["step"]) == float(sq["step"]) == steps
        if not bool(sp["exp_avg_sq"].any()):
            unreached += 1
            assert not bool(sq["exp_avg"].any() or sq["exp_avg_sq"].any())
            for _ in range(steps):
                w = w * (1 - lr * 1e-4)
            _close(p, w, "cpu")
            _close(q, w, "card")
        else:
            assert float((p - q).abs().max()) <= 2 * lr * steps + 1e-6
    assert unreached == 8


@pytest.mark.cuda
def test_kernel_raises_where_it_cannot_update(cuda):
    """On the card there is no second path: a bf16 parameter, and a group
    option the kernel does not have, raise at the step."""
    p = torch.nn.Parameter(torch.ones(4, device=cuda, dtype=torch.bfloat16))
    p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="f32"):
        pt.adamw([p], 1e-3).step()
    q = torch.nn.Parameter(torch.ones(4, device=cuda))
    q.grad = torch.ones_like(q)
    opt = optim.FusedAdamW([q], lr=1e-3, amsgrad=True, capturable=True)
    with pytest.raises(ValueError, match="amsgrad"):
        opt.step()
    assert opt.fused_steps == opt.fallback_steps == 0

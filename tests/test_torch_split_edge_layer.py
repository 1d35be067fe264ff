"""GraphCast's split first edge layer and its swish in one pass
(``ops/kernels/split_edge_layer.py``, ``csrc/split_edge_layer.cu``, the
route in ``models/graphcast.InteractionNetwork``).

On the CPU: the plain version against the composed expression it replaces
(``e @ W_e + P_s[senders] + P_r[receivers] + b``, then swish) in f32,
forward and gradients; in bf16 against its stated rounding points; the
layouts: padded edge rows, unsorted senders, receivers with empty and very
long runs; the gate and the interaction network's routes.

On the card (marked ``cuda``; skipped without one): the kernel and its
backward against the plain version at GraphCast_small's three shapes at 1
degree and 4 samples (the real graph's ids), relaunched bit for bit, and
the gradients of every input through autograd.

The file imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import graphnets_tpu_torch as pt
from graphnets_tpu_torch.models import graphcast
from graphnets_tpu_torch.ops.kernels import split_edge_layer as sel
from graphnets_tpu_torch.ops.scatter import gather_nodes

CASES = ("padded", "unsorted_senders", "empty_and_long_runs")


def _ids(case, E, n_s, n_r, rng):
    """int32 senders and ascending receivers of ``E`` edge rows."""
    if case == "padded":
        # The last quarter of the rows is padding: from the first padding
        # row of each table to the first padding row of the other.
        real = 3 * E // 4
        s = np.full(E, n_s - 1)
        r = np.full(E, n_r - 1)
        s[:real] = rng.integers(0, n_s - 1, real)
        r[:real] = np.sort(rng.integers(0, n_r - 1, real))
    elif case == "unsorted_senders":
        s = rng.permutation(np.arange(E) % n_s)
        r = np.sort(rng.integers(0, n_r, E))
    else:
        # Every other receiver has no edge; one takes half of the rows.
        r = np.sort(np.concatenate([
            np.full(E // 2, n_r // 2),
            2 * rng.integers(0, n_r // 2, E - E // 2)]))
        s = rng.integers(0, n_s, E)
    return (torch.from_numpy(s.astype(np.int32)),
            torch.from_numpy(r.astype(np.int32)))


def _inputs(case, dtype, E=256, D=128, H=128, n_s=40, n_r=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    senders, receivers = _ids(case, E, n_s, n_r, np.random.default_rng(seed))

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dtype)
    return dict(e=rand(E, D), w_e=rand(D, H, scale=D ** -0.5),
                p_s=rand(n_s, H), p_r=rand(n_r, H), b=rand(H),
                senders=senders, receivers=receivers)


def _composed(e, w_e, p_s, p_r, b, senders, receivers):
    """The expression the kernel replaces (``models/graphcast.py`` before
    it): ``(pre, h)``."""
    pre = (e @ w_e + gather_nodes(p_s, senders)
           + gather_nodes(p_r, receivers, idx_sorted=True) + b)
    return pre, F.silu(pre)


def _leaves(x):
    return {k: (v.clone().requires_grad_(True) if v.is_floating_point()
                else v) for k, v in x.items()}


FLOATS = ("e", "w_e", "p_s", "p_r", "b")


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_composed_in_f32(case):
    """f32: ``pre``, ``h`` and the gradients of every float input within
    1e-5 (relative to each tensor's norm): the two differ only in the order
    of the f32 adds."""
    x = _inputs(case, torch.float32)
    pre, h = sel.split_edge_layer_plain(**x)
    cpre, ch = _composed(**x)
    for got, want in ((pre, cpre), (h, ch)):
        assert float((got - want).norm() / want.norm()) < 1e-5
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(1))
    a, c = _leaves(x), _leaves(x)
    (sel.split_edge_layer(**a) * g).sum().backward()
    (_composed(**c)[1] * g).sum().backward()
    for k in FLOATS:
        gap = float((a[k].grad - c[k].grad).norm() / c[k].grad.norm())
        assert gap < 1e-5, (k, gap)


def _bf16_key(t):
    """bf16 values as integers in their order, so that neighbours differ by
    one (+0 and -0 are both 0)."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _ulps(a, b):
    return int((_bf16_key(a) - _bf16_key(b)).abs().max())


def _ulp_err(a, b):
    """The largest ``|a - b|`` in bf16 ulps of ``b``'s values, an ulp taken
    no smaller than 2^-16 of ``b``'s largest magnitude: a sum that cancels
    to near 0 moves by ~1e-6 of its terms with the f32 adds' order, where
    bf16's own ulp is far smaller."""
    a, b = a.float(), b.float()
    ulp = torch.ldexp(torch.ones_like(b), torch.frexp(b.abs())[1] - 8)
    ulp = torch.where(b == 0, 0.0, ulp)
    ulp = torch.maximum(ulp, 2.0 ** -16 * b.abs().max())
    return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_rounds_where_the_kernel_states_in_bf16(case):
    """bf16: ``pre`` is the f32 sum rounded once and ``h`` swish of the
    rounded ``pre`` in f32 rounded once, exactly (the inputs are small
    multiples of powers of two, so every f32 sum is exact and the reference
    can be taken in f64); ``d_pre`` is the f32 swish backward rounded once
    (within one bf16 ulp of the f64 one: the f32 steps may round across a
    bf16 tie) and ``d_b`` the sums of the rounded ``d_pre``.  The composed
    bf16 expression, rounding after every op, is further from the f64
    ``pre``."""
    gen = torch.Generator().manual_seed(2)
    x = _inputs(case, torch.bfloat16)
    for k in FLOATS:
        x[k] = (torch.randint(-8, 9, x[k].shape, generator=gen)
                * 2.0 ** -3).to(torch.bfloat16)
    pre, h = sel.split_edge_layer_plain(**x)
    s, r = x["senders"].long(), x["receivers"].long()
    exact = (x["e"].double() @ x["w_e"].double()
             + x["p_s"].double()[s] + x["p_r"].double()[r] + x["b"].double())
    assert torch.equal(pre, exact.float().to(torch.bfloat16))
    assert torch.equal(h, F.silu(pre.float()).to(torch.bfloat16))
    cpre = _composed(**x)[0]
    assert (float((pre.double() - exact).abs().max())
            < float((cpre.double() - exact).abs().max()))
    d_h = torch.randn(h.shape, generator=gen).to(torch.bfloat16)
    d_pre, d_b = sel.split_edge_backward_plain(d_h, pre)
    xd = pre.double()
    sd = torch.sigmoid(xd)
    want = (d_h.double() * sd * (1 + xd * (1 - sd))).to(torch.bfloat16)
    assert _ulps(d_pre, want) <= 1
    assert d_b.dtype == torch.float32
    assert torch.allclose(d_b.double(), d_pre.double().sum(0), rtol=1e-6,
                          atol=1e-6)


@pytest.mark.parametrize("shape,ok", [
    ((327_680, 512, 512, torch.bfloat16, True), True),
    ((128, 128, 128, torch.bfloat16, True), True),
    ((256, 768, 2048, torch.bfloat16, True), True),
    ((327_680, 512, 512, torch.float32, True), False),
    ((327_600, 512, 512, torch.bfloat16, True), False),
    ((327_680, 96, 512, torch.bfloat16, True), False),
    ((327_680, 512, 200, torch.bfloat16, True), False),
    ((327_680, 896, 512, torch.bfloat16, True), False),
    ((327_680, 512, 4096, torch.bfloat16, True), False),
    ((327_680, 512, 512, torch.bfloat16, False), False),
    ((0, 512, 512, torch.bfloat16, True), False),
])
def test_gate(shape, ok):
    rows, latent, hidden, dtype, rsorted = shape
    assert sel.supports_split_edge_layer(rows, latent, hidden, dtype,
                                         rsorted) is ok


@pytest.mark.parametrize("case", ["accepted", "f32", "ragged_rows",
                                  "kernels_off"])
def test_interaction_network_routes(case, monkeypatch):
    """Where the kernels are on and the gate holds, a CUDA tensor goes
    through ``split_edge_layer``; elsewhere the composed expression (a
    tensor on the meta device stands in for the card's).  Both routes give
    the same update in f32 on the CPU (1e-5)."""
    rows, dtype, kernels = {"accepted": (256, torch.bfloat16, True),
                            "f32": (256, torch.float32, True),
                            "ragged_rows": (200, torch.bfloat16, True),
                            "kernels_off": (256, torch.bfloat16, False)}[case]
    monkeypatch.setattr(graphcast, "use_kernels", lambda: kernels)
    calls = []
    real = graphcast.split_edge_layer

    def spy(*args):
        calls.append(args[0].device.type)
        return real(*args)
    monkeypatch.setattr(graphcast, "split_edge_layer", spy)
    e = torch.empty(rows, 128, dtype=dtype, device="meta")
    assert graphcast._takes_split_layer(e, 128, 128) is (case == "accepted")

    x = _inputs("padded", torch.float32, E=256, D=32, H=32, n_s=24, n_r=24)
    net = graphcast.InteractionNetwork(32, 32, device="cpu")
    es = pt.EdgeSet(x["senders"], x["receivers"], x["e"][:, :4], 200)
    v = torch.randn(24, 32, generator=torch.Generator().manual_seed(3))
    outs = []
    for split in (True, False):
        monkeypatch.setattr(graphcast, "_takes_split_layer",
                            lambda *a, split=split: split)
        outs.append(net(x["e"][:, :32].contiguous(), v, v, es))
    assert calls == ["cpu"]
    for got, want in zip(*outs):
        assert float((got - want).detach().norm() / want.detach().norm()) \
            < 1e-5


def test_cpu_launches_no_kernel():
    x = _leaves(_inputs("padded", torch.float32))
    before = (sel.LAUNCHES, sel.LAUNCHES_BWD)
    sel.split_edge_layer(**x).sum().backward()
    assert (sel.LAUNCHES, sel.LAUNCHES_BWD) == before


# ---- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def one_degree_ids():
    """The 1 degree graph's ids for 4 samples, by edge set: ``(senders,
    receivers, sender rows, receiver rows)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    tg = pt.batch_samples(pt.build_graphcast_graph(1.0, 5, 0.6), 4,
                          device="cuda")
    ends = {"g2m": ("grid", "mesh"), "mesh": ("mesh", "mesh"),
            "m2g": ("mesh", "grid")}
    return {k: (es.senders, es.receivers, tg.num_nodes(ends[k][0]),
                tg.num_nodes(ends[k][1])) for k, es in tg.edges.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("edge_set", ["mesh", "g2m", "m2g"])
def test_kernel_against_plain_on_the_card(edge_set, one_degree_ids):
    """GraphCast_small's shapes (latent = hidden = 512, 4 samples at 1
    degree): the processor's [327,680, 512], g2m's [407,680, 512] and m2g's
    [781,952, 512].  Forward: ``pre`` within one bf16 ulp of the plain
    version's (the f32 sums' order may round across a bf16 tie; an ulp no
    smaller than 2^-16 of the largest magnitude, see ``_ulp_err``), ``h``
    within one ulp of swish of the kernel's own ``pre`` (swish's slope
    makes one ulp of ``pre`` several of ``h`` where ``pre`` is negative),
    relaunched bit for bit.  Backward: ``d_pre`` within one ulp
    (the same reason); ``d_b`` within 1e-5 of each column's sum of |d_pre|
    of the f64 sums of the kernel's own ``d_pre`` (only the f32 order
    differs).  Through autograd, every input's gradient within 1e-2 of its
    norm of the plain route's (the one-ulp differences of ``d_pre`` carried
    through bf16 products and sums), and a second backward through the same
    graph raises (``d_pre`` is written over the saved ``pre``).  The launch
    counters count one forward and one backward."""
    senders, receivers, n_s, n_r = one_degree_ids[edge_set]
    E, D = senders.shape[0], 512
    dev = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(7)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device=dev)
                    ).to(torch.bfloat16)
        x = dict(e=rand(E, D), w_e=rand(D, D, scale=D ** -0.5),
                 p_s=rand(n_s, D), p_r=rand(n_r, D), b=rand(D),
                 senders=senders, receivers=receivers)
        before = sel.LAUNCHES
        pre, h = sel._forward_kernel(**x)
        pre2, h2 = sel._forward_kernel(**x)
        assert sel.LAUNCHES == before + 2
        ppre, _ = sel.split_edge_layer_plain(**x)
        torch.cuda.synchronize()
        assert torch.equal(pre, pre2) and torch.equal(h, h2)
        assert _ulp_err(pre, ppre) <= 1
        assert _ulp_err(h, F.silu(pre.float()).to(torch.bfloat16)) <= 1
        d_h = rand(E, D)
        before = sel.LAUNCHES_BWD
        d_pre, d_b = sel._backward_kernel(d_h, pre.clone())
        assert sel.LAUNCHES_BWD == before + 1
        p_pre, _ = sel.split_edge_backward_plain(d_h, pre)
        assert _ulps(d_pre, p_pre) <= 1
        scale = d_pre.double().abs().sum(0)
        assert bool(((d_b.double() - d_pre.double().sum(0)).abs()
                     <= 1e-5 * scale).all())
        a, c = _leaves(x), _leaves(x)
        out = sel.split_edge_layer(**a)
        out.backward(d_h, retain_graph=True)
        with pytest.raises(RuntimeError):  # d_pre is written over pre
            out.backward(d_h)
        sel.split_edge_layer_plain(**c)[1].backward(d_h)
        for k in FLOATS:
            gap = float((a[k].grad.float() - c[k].grad.float()).norm()
                        / c[k].grad.float().norm())
            assert gap < 1e-2, (k, gap)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ``h`` and the FFN output are bf16, held to one and two bf16
ulps at the largest magnitude (the kernels' f32 sums run in another order,
so a value near a rounding boundary may round the other way); ``agg`` is
held to 1e-4 against an f32 sum of the kernel's own ``h``.  The segment
sums: one bf16 ulp of the largest magnitude, f32 at rtol 1e-5; the gather
is bit-equal; the LN backward: dx at 2^-6 and dW, dscale, dbias at 1e-3 of
the largest magnitude; the edge update's gradients at 5e-2 of each
tensor's largest magnitude (bf16 cotangents).
"""

import numpy as np
import pytest
import torch

from graphnets_tpu_torch.ops.kernels import edge_update as eu
from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
from graphnets_tpu_torch.ops.kernels import gather as ga
from graphnets_tpu_torch.ops.kernels import ln_linear as ll
from graphnets_tpu_torch.ops.kernels import segment_sum as ss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _uniform_ids(rng, G, n_slots, e_slots, padded):
    snd, rcv = [], []
    for b in range(G):
        n_real = n_slots - 1 if padded else n_slots
        e_real = e_slots - 37 if padded else e_slots
        s = rng.integers(0, n_real, e_slots) + b * n_slots
        r = np.sort(rng.integers(0, n_real, e_slots)) + b * n_slots
        s[e_real:] = r[e_real:] = (b + 1) * n_slots - 1
        snd.append(s)
        rcv.append(r)
    to = lambda x: torch.from_numpy(np.concatenate(x).astype(np.int32))
    return to(snd), to(rcv)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_ln", [True, False])
def test_edge_update_agg_matches_plain(cuda, padded, use_ln):
    G, n_slots, e_slots, d = 4, 32, 256, 128
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    ef, w0 = f(G * e_slots, d).bfloat16(), (f(d, d) * 0.05).bfloat16()
    ts, tr, tg, b = f(G * n_slots, d), f(G * n_slots, d), f(G, d), f(d)
    ln = {"scale": f(d), "bias": f(d)} if use_ln else None
    args = (ef, ln, w0, ts, tr, tg, b, snd, rcv, n_slots, e_slots)
    h_p, _ = eu.fused_edge_update_agg(*args)  # CPU: the plain version
    on = lambda t: t.to(cuda) if isinstance(t, torch.Tensor) else t
    before = eu.LAUNCHES
    h_k, agg_k = eu.fused_edge_update_agg(
        *[({k: on(v) for k, v in a.items()} if isinstance(a, dict) else on(a))
          for a in args])
    torch.cuda.synchronize()
    assert eu.LAUNCHES == before + 1
    tol = 2.0 ** -7 * float(h_p.float().abs().max())
    assert float((h_k.float().cpu() - h_p.float()).abs().max()) <= tol
    own = torch.zeros_like(agg_k).index_add_(0, rcv.to(cuda), h_k.float())
    assert torch.allclose(agg_k, own, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 1000, 4096])
@pytest.mark.parametrize("d", [128, 384])
def test_ln_ffn_residual_matches_plain(cuda, rows, d):
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    args = [f(rows, d).bfloat16(), f(d), f(d), (f(d, 4 * d) * 0.05).bfloat16(),
            f(4 * d).bfloat16(), (f(4 * d, d) * 0.05).bfloat16(),
            f(d).bfloat16()]
    extra = f(rows, d).bfloat16()
    ref = ffn.ln_ffn_residual(*args, extra=extra)  # CPU: the plain version
    before = ffn.LAUNCHES
    out = ffn.ln_ffn_residual(*[t.to(cuda) for t in args],
                              extra=extra.to(cuda))
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 1
    tol = 2.0 ** -6 * float(ref.float().abs().max())
    assert float((out.float().cpu() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, 384, device=cuda)  # float32: the kernel takes bf16
    w1, w2 = torch.zeros(384, 1536, device=cuda), torch.zeros(1536, 384,
                                                             device=cuda)
    v = lambda n: torch.zeros(n, device=cuda)
    with pytest.raises(ValueError):
        ffn.ln_ffn_residual(x, v(384), v(384), w1, v(1536), w2, v(384))


def _close_max(out, ref, tol):
    out, ref = out.float().cpu(), ref.float().cpu()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [128, 96])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segment_sums_match_plain(cuda, dtype, padded, n_slots):
    """Sorted (receivers) and windowed (senders) sums; at n_slots = 96 a
    128-segment tile of the windowed kernel spans two graphs."""
    G, e_slots, d = 6, 1024, 384
    rng = np.random.default_rng(10)
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    x = torch.from_numpy(rng.normal(size=(G * e_slots, d)).astype(
        np.float32)).to(dtype)
    N = G * n_slots
    gi = torch.arange(G + 1, dtype=torch.int32)
    wins = (gi * n_slots, gi * e_slots)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    before = (ss.LAUNCHES, ss.WINDOWED_LAUNCHES)
    out = ss.sorted_segment_sum(x.to(cuda), rcv.to(cuda), N)
    win = ss.windowed_segment_sum(x.to(cuda), snd.to(cuda), N,
                                  *[w.to(cuda) for w in wins])
    torch.cuda.synchronize()
    assert (ss.LAUNCHES, ss.WINDOWED_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    assert out.dtype == win.dtype == dtype
    _close_max(out, ss.sorted_segment_sum_plain(x, rcv, N), tol)
    _close_max(win, ss.windowed_segment_sum_plain(x, snd, N, *wins), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sorted_gather_is_bit_equal(cuda, dtype):
    rng = np.random.default_rng(11)
    _, rcv = _uniform_ids(rng, 4, 128, 2048, True)
    rcv[-5:] = 512  # past the table: zero rows
    table = torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32)).to(dtype)
    before = ga.LAUNCHES
    out = ga.sorted_gather(table.to(cuda), rcv.to(cuda))
    torch.cuda.synchronize()
    assert ga.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ga.sorted_gather_plain(table, rcv))
    assert not out[-5:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1000, 4096])
@pytest.mark.parametrize("d", [128, 384])
def test_ln_linear_backward_matches_plain(cuda, d, T):
    rng = np.random.default_rng(12)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = f(T, d)
    x[:3] = 0.0  # var == 0 rows
    args = [x.bfloat16(), 1 + 0.1 * f(d), 0.1 * f(d),
            (f(d, 384) * d ** -0.5).bfloat16(), f(T, 384).bfloat16()]
    ref = ll.ln_linear_backward(*args)  # CPU: the plain version
    before = ll.LAUNCHES
    out = ll.ln_linear_backward(*[t.to(cuda) for t in args])
    torch.cuda.synchronize()
    assert ll.LAUNCHES == before + 1
    assert out[0].dtype == torch.bfloat16
    for o, r, tol in zip(out, ref, (2.0 ** -6, 1e-3, 1e-3, 1e-3)):
        _close_max(o, r, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
def test_fused_edge_update_and_gradients_match_plain(cuda, padded):
    G, n_slots, e_slots, d = 4, 32, 256, 128
    rng = np.random.default_rng(13)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    snd, rcv = _uniform_ids(rng, G, n_slots, e_slots, padded)
    base = {"ef": f(G * e_slots, d).bfloat16(), "scale": 1 + 0.1 * f(d),
            "bias": 0.1 * f(d), "w0": (f(d, d) * 0.05).bfloat16(),
            "ts": f(G * n_slots, d), "tr": f(G * n_slots, d),
            "tg": f(G, d), "b": f(d)}
    ct = f(G * e_slots, d).bfloat16()
    results = []
    for dev in ("cpu", cuda):
        ins = {k: v.to(dev).detach().requires_grad_()
               for k, v in base.items()}
        h = eu.fused_edge_update(
            ins["ef"], {"scale": ins["scale"], "bias": ins["bias"]},
            ins["w0"], ins["ts"], ins["tr"], ins["tg"], ins["b"],
            snd.to(dev), rcv.to(dev), n_slots, e_slots)
        h.backward(ct.to(dev))
        results.append((h, {k: v.grad for k, v in ins.items()}))
    torch.cuda.synchronize()
    (h_p, g_p), (h_k, g_k) = results
    _close_max(h_k, h_p, 2.0 ** -7)
    for k in base:
        _close_max(g_k[k], g_p[k], 5e-2)


@pytest.mark.cuda
def test_training_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(64, 384, device=cuda)  # float32: the kernel takes bf16
    v = torch.zeros(384, device=cuda)
    with pytest.raises(ValueError):
        ll.ln_linear_backward(x, v, v, torch.zeros(384, 384, device=cuda),
                              x)
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(x, torch.zeros(64, dtype=torch.int64,
                                             device=cuda), 8)
    with pytest.raises(ValueError):
        ga.sorted_gather(torch.zeros(8, 3, device=cuda),
                         torch.zeros(4, dtype=torch.int32, device=cuda))

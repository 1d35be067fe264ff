"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ``h`` and the FFN output are bf16, held to one and two bf16
ulps at the largest magnitude (the kernels' f32 sums run in another order,
so a value near a rounding boundary may round the other way); ``agg`` is
held to 1e-4 against an f32 sum of the kernel's own ``h``.
"""

import numpy as np
import pytest
import torch

from graphnets_tpu_torch.ops.kernels import edge_update as eu
from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn


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

"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions, which carry the
CUDA kernels' rounding points; the JAX kernels run in Pallas interpret
mode.  The same numpy inputs go to both.  Tolerances: bf16 outputs at the
JAX kernel tests' 5e-2, the f32 edge->node sum at 1e-4 against an f32 sum
of the rounded h, and f32 runs at 1e-5 against the JAX references.  The
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphnets_tpu.utils.config import enable_pallas, get_config
from graphnets_tpu_torch.ops.kernels import edge_update as pt_eu
from graphnets_tpu_torch.ops.kernels import fused_ffn as pt_ffn
from graphnets_tpu_torch.ops.kernels import random_gather as pt_rg


@pytest.fixture
def interpret_mode():
    old = (get_config().use_pallas, get_config().pallas_interpret)
    enable_pallas(True, interpret=True)
    yield
    enable_pallas(old[0], interpret=old[1])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _edge_inputs(seed, G, n_slots, e_slots, d, padded):
    """A uniform layout: receivers ascending inside each graph slot; with
    ``padded`` the tail of every slot's edges targets its last node."""
    rng = np.random.default_rng(seed)
    N, E = G * n_slots, G * e_slots
    snd, rcv = [], []
    for b in range(G):
        n_real = n_slots - 1 if padded else n_slots
        e_real = e_slots - 37 if padded else e_slots
        s = rng.integers(0, n_real, e_slots) + b * n_slots
        r = np.sort(rng.integers(0, n_real, e_slots)) + b * n_slots
        s[e_real:] = r[e_real:] = (b + 1) * n_slots - 1
        snd.append(s)
        rcv.append(r)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(ef=f(E, d), scale=f(d), bias=f(d), w0=f(d, d) * 0.05,
                ts=f(N, d), tr=f(N, d), tg=f(G, d), b=f(d),
                senders=np.concatenate(snd).astype(np.int32),
                receivers=np.concatenate(rcv).astype(np.int32))


def _port_edge(a, dtype, use_ln=True):
    ln = {"scale": _t(a["scale"]), "bias": _t(a["bias"])} if use_ln else None
    return pt_eu.fused_edge_update_agg(
        _t(a["ef"], dtype), ln, _t(a["w0"], dtype), _t(a["ts"]), _t(a["tr"]),
        _t(a["tg"]), _t(a["b"]), torch.from_numpy(a["senders"]),
        torch.from_numpy(a["receivers"]), a["n_slots"], a["e_slots"])


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_ln", [True, False])
def test_fused_edge_update_agg_matches_pallas(interpret_mode, padded,
                                              use_ln):
    from graphnets_tpu.ops.pallas.edge_update import (
        fused_edge_update_agg, supports_fused_edge_update)
    G, n_slots, e_slots, d = 2, 16, 128, 128
    assert supports_fused_edge_update(G * e_slots, G * n_slots, G, d, d,
                                      n_slots, e_slots, jnp.bfloat16,
                                      with_agg=True)
    assert pt_eu.supports_fused_edge_update(G * e_slots, G * n_slots, G, d,
                                            d, n_slots, e_slots,
                                            torch.bfloat16)
    a = _edge_inputs(3, G, n_slots, e_slots, d, padded)
    a.update(n_slots=n_slots, e_slots=e_slots)
    bf = jnp.bfloat16
    ln = ({"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])}
          if use_ln else None)
    h_j, agg_j = fused_edge_update_agg(
        jnp.asarray(a["ef"], bf), ln, jnp.asarray(a["w0"], bf),
        jnp.asarray(a["ts"]), jnp.asarray(a["tr"]), jnp.asarray(a["tg"]),
        jnp.asarray(a["b"]), jnp.asarray(a["senders"]),
        jnp.asarray(a["receivers"]), n_slots, e_slots)
    before = pt_eu.LAUNCHES
    h_p, agg_p = _port_edge(a, torch.bfloat16, use_ln)
    assert pt_eu.LAUNCHES == before  # CPU tensors never launch
    assert h_p.dtype == torch.bfloat16 and agg_p.dtype == torch.float32
    np.testing.assert_allclose(h_p.float().numpy(),
                               np.asarray(h_j, np.float32),
                               rtol=5e-2, atol=5e-2)
    # The sum is of the ROUNDED h, in f32.
    ref_agg = np.zeros((G * n_slots, d), np.float64)
    np.add.at(ref_agg, a["receivers"], h_p.float().numpy())
    np.testing.assert_allclose(agg_p.numpy(), ref_agg, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(agg_p.numpy(), np.asarray(agg_j),
                               rtol=5e-2, atol=5e-1)


def test_fused_edge_update_agg_f32_matches_reference():
    from graphnets_tpu.ops.pallas.edge_update import \
        fused_edge_update_reference
    G, n_slots, e_slots, d = 2, 16, 128, 128
    a = _edge_inputs(4, G, n_slots, e_slots, d, padded=True)
    a.update(n_slots=n_slots, e_slots=e_slots)
    ref = fused_edge_update_reference(
        jnp.asarray(a["ef"]),
        {"scale": jnp.asarray(a["scale"]), "bias": jnp.asarray(a["bias"])},
        jnp.asarray(a["w0"]), jnp.asarray(a["ts"]), jnp.asarray(a["tr"]),
        jnp.asarray(a["tg"]), jnp.asarray(a["b"]), jnp.asarray(a["senders"]),
        jnp.asarray(a["receivers"]), e_slots)
    h, agg = _port_edge(a, torch.float32)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    seg = jax.ops.segment_sum(ref, jnp.asarray(a["receivers"]),
                              num_segments=G * n_slots)
    np.testing.assert_allclose(agg.numpy(), np.asarray(seg), rtol=1e-5,
                               atol=1e-4)


def _ffn_inputs(seed, rows, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=f(rows, d), scale=f(d), bias=f(d), w1=f(d, 4 * d) * 0.05,
                b1=f(4 * d), w2=f(4 * d, d) * 0.05, b2=f(d), extra=f(rows, d))


_FFN_KEYS = ("x", "scale", "bias", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("rows", [8, 256])
def test_ln_ffn_residual_matches_pallas(interpret_mode, rows, with_extra):
    from graphnets_tpu.ops.pallas.fused_ffn import _fused_forward
    d = 128
    a = _ffn_inputs(5, rows, d)
    bf = jnp.bfloat16
    jx = {k: jnp.asarray(a[k]) for k in _FFN_KEYS}
    for k in ("x", "w1", "b1", "w2", "b2"):
        jx[k] = jx[k].astype(bf)
    extra_j = jnp.asarray(a["extra"], bf) if with_extra else None
    out_j = _fused_forward(*[jx[k] for k in _FFN_KEYS], extra=extra_j)
    pt = {k: _t(a[k]) for k in _FFN_KEYS}
    for k in ("x", "w1", "b1", "w2", "b2"):
        pt[k] = pt[k].to(torch.bfloat16)
    extra_p = _t(a["extra"], torch.bfloat16) if with_extra else None
    before = pt_ffn.LAUNCHES
    out_p = pt_ffn.ln_ffn_residual(*[pt[k] for k in _FFN_KEYS],
                                   extra=extra_p)
    assert pt_ffn.LAUNCHES == before
    assert out_p.dtype == torch.bfloat16 and out_p.shape == (rows, d)
    np.testing.assert_allclose(out_p.float().numpy(),
                               np.asarray(out_j, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("fn", ["ln_ffn_residual", "ln_ffn_residual_reference"])
def test_ln_ffn_residual_f32_matches_reference(fn):
    from graphnets_tpu.ops.pallas.fused_ffn import ln_ffn_residual_reference
    a = _ffn_inputs(6, 64, 128)
    ref = ln_ffn_residual_reference(*[jnp.asarray(a[k]) for k in _FFN_KEYS],
                                    extra=jnp.asarray(a["extra"]))
    out = getattr(pt_ffn, fn)(*[_t(a[k]) for k in _FFN_KEYS],
                              extra=_t(a["extra"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_ln_ffn_residual_reference_bf16_matches_jax():
    from graphnets_tpu.ops.pallas.fused_ffn import ln_ffn_residual_reference
    a = _ffn_inputs(7, 32, 128)
    ref = ln_ffn_residual_reference(
        *[jnp.asarray(a[k], jnp.bfloat16) for k in _FFN_KEYS],
        extra=jnp.asarray(a["extra"], jnp.bfloat16))
    out = pt_ffn.ln_ffn_residual_reference(
        *[_t(a[k], torch.bfloat16) for k in _FFN_KEYS],
        extra=_t(a["extra"], torch.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_kernel_gates():
    bf = torch.bfloat16
    assert pt_eu.supports_fused_edge_update(16384, 1024, 8, 384, 384, 128,
                                            2048, bf)
    assert not pt_eu.supports_fused_edge_update(16384, 1024, 8, 384, 384,
                                                128, 2048, torch.float32)
    assert not pt_eu.supports_fused_edge_update(2048, 128, 1, 384, 384, 128,
                                                2048, bf)   # G = 1
    assert not pt_eu.supports_fused_edge_update(16384, 1024, 8, 512, 384,
                                                128, 2048, bf)  # VMEM budget
    assert not pt_eu.supports_fused_edge_update(16384, 1024, 8, 96, 384,
                                                128, 2048, bf)
    for rows in (8, 1024, 16384):
        assert pt_ffn.supports_fused_ffn(rows, 384, bf)
    assert not pt_ffn.supports_fused_ffn(3, 384, bf)     # not whole 8-row tiles
    assert not pt_ffn.supports_fused_ffn(0, 384, bf)
    assert pt_ffn.supports_fused_ffn(64, 512, bf)
    assert not pt_ffn.supports_fused_ffn(64, 640, bf)    # the VMEM term
    assert pt_ffn.supports_fused_ffn(64, 384, torch.float32)
    assert not pt_ffn.supports_fused_ffn(64, 384, torch.float16)


@pytest.mark.parametrize("rows", [7, 8, 64, 200])
@pytest.mark.parametrize("d", [128, 200, 256, 384, 512, 640])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_supports_fused_ffn_matches_jax(dtype, d, rows):
    """The port's FFN gate is the JAX package's (``fused_ffn.py:99-105``)
    on bf16 and f32 rows."""
    from graphnets_tpu.ops.pallas.fused_ffn import supports_fused_ffn
    assert pt_ffn.supports_fused_ffn(rows, d, dtype) == \
        supports_fused_ffn(rows, d)


@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ln_ffn_residual_wide_and_f32_match_pallas(interpret_mode, dtype, d):
    """The forward at the widths and row type the repaired gate lets
    through: the plain version (the CUDA kernel's yardstick) against the
    JAX kernel in interpret mode; bf16 at the JAX kernel tests' 5e-2, f32
    at 1e-5 of the largest magnitude (the same f32 sums in another
    order)."""
    from graphnets_tpu.ops.pallas.fused_ffn import _fused_forward
    rows = 16
    a = _ffn_inputs(8, rows, d)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jx = {k: jnp.asarray(a[k]) for k in _FFN_KEYS}
    pt = {k: _t(a[k]) for k in _FFN_KEYS}
    for k in ("x", "w1", "b1", "w2", "b2"):
        jx[k] = jx[k].astype(jdt)
        pt[k] = pt[k].to(tdt)
    out_j = np.asarray(_fused_forward(*[jx[k] for k in _FFN_KEYS],
                                      extra=jnp.asarray(a["extra"], jdt)),
                       np.float32)
    assert pt_ffn.supports_fused_ffn(rows, d, tdt)
    out_p = pt_ffn.ln_ffn_residual(*[pt[k] for k in _FFN_KEYS],
                                   extra=_t(a["extra"], tdt))
    assert out_p.dtype == tdt and out_p.shape == (rows, d)
    if dtype == "bf16":
        np.testing.assert_allclose(out_p.float().numpy(), out_j, rtol=5e-2,
                                   atol=5e-2)
    else:
        err = np.abs(out_p.numpy() - out_j).max()
        assert err <= 1e-5 * np.abs(out_j).max(), err


# -- random_gather --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_random_gather_matches_pallas(interpret_mode, dtype):
    """The plain version and its gradient (one sort, then the sorted f32
    segment sum) against the JAX package's kernel in interpret mode: the
    rows bit-equal, the table gradient at 1e-5 in f32 and one bf16 ulp of
    the largest magnitude in bf16 (an f32 sum in another order)."""
    from graphnets_tpu.ops.pallas import random_gather as j_rg
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    rng = np.random.default_rng(8)
    N, d, E = 96, 128, 1024
    table = rng.normal(size=(N, d)).astype(np.float32)
    idx = rng.integers(0, N, E).astype(np.int32)
    ct = rng.normal(size=(E, d)).astype(np.float32)
    assert j_rg.supports_random_gather(E, N, d)
    out_j, vjp = jax.vjp(lambda t: j_rg.random_gather(t, jnp.asarray(idx)),
                         jnp.asarray(table, jdt))
    (grad_j,) = vjp(jnp.asarray(ct, jdt))
    t = _t(table, tdt).requires_grad_()
    before = pt_rg.LAUNCHES
    out_p = pt_rg.random_gather(t, torch.from_numpy(idx))
    out_p.backward(_t(ct, tdt))
    assert pt_rg.LAUNCHES == before            # CPU: no launch
    np.testing.assert_array_equal(out_p.detach().float().numpy(),
                                  np.asarray(out_j, np.float32))
    assert t.grad.dtype == tdt
    ref = np.asarray(grad_j, np.float32)
    tol = (1e-5 if dtype == "f32" else 2.0 ** -7) * np.abs(ref).max()
    assert np.abs(t.grad.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("shape", [
    (1048576, 65536, 256), (512, 1, 128), (1024, 96, 384), (768, 96, 128),
    (256, 96, 128), (1000, 96, 128), (512, 96, 100), (2048, 7, 128)])
def test_supports_random_gather_matches_jax(shape):
    from graphnets_tpu.ops.pallas import random_gather as j_rg
    assert pt_rg.supports_random_gather(*shape) == \
        j_rg.supports_random_gather(*shape)


def test_random_gather_outside_its_gate_takes_index_select():
    """E not a multiple of 512: both packages take the library gather, and
    the gradient is autograd's."""
    from graphnets_tpu.ops.pallas import random_gather as j_rg
    rng = np.random.default_rng(9)
    table = rng.normal(size=(40, 128)).astype(np.float32)
    idx = rng.integers(0, 40, 100).astype(np.int32)
    assert not pt_rg.supports_random_gather(100, 40, 128)
    t = _t(table).requires_grad_()
    out = pt_rg.random_gather(t, torch.from_numpy(idx))
    out.sum().backward()
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(j_rg.random_gather(jnp.asarray(table), jnp.asarray(idx))))
    np.testing.assert_allclose(
        t.grad.numpy()[:, 0], np.bincount(idx, minlength=40).astype(
            np.float32))

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``graphnets_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line
(4b and the training kernels of phase 3 came with the training slice):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``graphnets_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (all sources at once) and print the build time and the
   compiler's register/spill report;
3. hold each kernel against its plain torch version on the card, at the
   shapes the main path gives it: the fused edge update on the headline
   layout and on a padded uniform layout, the fused LN->FFN->residual at
   T = 16384, 1024 and 8 rows; record the largest error against the stated
   tolerance, and time kernel and plain version with CUDA events
   (warm-up excluded): device time from a replayed CUDA graph, and the
   eager per-call time with its host cost.  The training kernels likewise:
   the non-agg edge update, the sorted and windowed segment sums
   ([16384, 384] bf16 into 1024 segments), the sorted gather ([1024, 384]
   to 16384 rows, bit-equal) and the LN->matmul backward (T = 16384,
   d = dout = 384), with the time of one PyTorch call computing the same
   function where there is one (``index_add_``, ``index_select``);
4. run the main path: the headline forward of ``bench.py`` (8 graphs x 128
   nodes x in-degree 16, E = 16384, batched with
   ``PadSpec.uniform(128, 2048)``; 3 GNCores at (384, 384, 384); bf16
   activations and seeded bf16 params) with the launch counters set to 0
   just before and read just after: it must launch the edge kernel 3 times
   and the FFN kernel 9 times.  The output must be finite and match the
   same model on the pure route (kernels off) on the card.  Print the
   forward time (eager, and replayed as a CUDA graph), edges/s, and a
   profile of one eager forward (device time by kernel, idle share);
4b. run the headline training step (``benchmarks/bench_train_step.py``:
   the same batch and model, f32 master params, bf16 compute, random bf16
   node and edge targets, ``graph_loss_nf_ef``, AdamW(3e-4)) through
   ``make_train_step`` with the counters set to 0 just before one step
   and read just after: per step 3 non-agg edge updates, 6 sorted and 3
   windowed segment sums, 3 sorted gathers and 3 LN backwards, and no
   inference kernel.  Its loss and every gradient must match the pure
   route's on the card: the loss within 1e-2 relative, each gradient
   within 5e-2 of its tensor's largest magnitude or, where that is
   larger, within the distance between the pure route in bf16 and in f32
   (the CPU tests' rule: a bf16 ulp that flips a relu moves a gradient of
   the 8-row graph set by far more than 5e-2).  The loss over 5 steps
   must stay finite.  Print the eager step time, edges/s and a profile of
   one step;
5. print one JSON line listing the kernels, then the ``ok`` line.

Float32 products everywhere run without TF32 (set below), so the plain
versions' f32 matmuls are exact-product, f32-accumulate.  The script
imports neither JAX nor the JAX package.
"""

import json
import subprocess
import sys
import time

import numpy as np

# Headline workload (bench.py).
B, N_PER_G, DEG, D = 8, 128, 16, 384
N_CORES = 3
H100_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, HBM3
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
WARMUP, ITERS = 3, 20


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=ITERS, warmup=WARMUP):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=ITERS):
    """Device time of one call of ``fn`` without the host: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events (after a
    warm-up on a side stream and one untimed replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_forward(torch, fn, host_rows=None):
    """Device time by kernel name over one call of ``fn``
    (``torch.profiler``), the summed device time and the host wall time.
    ``host_rows`` (filled when given) gets the host ops by self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if host_rows is not None and ev.device_type == \
                torch.autograd.DeviceType.CPU:
            host_rows.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            # Host ops and annotated ranges (the optimizer's step): their
            # kernels are listed on their own.
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows), wall_ms


def bound_ms(nbytes, flops, flops_f32=0):
    """The least time for the work: bytes over the memory rate against bf16
    tensor-core operations plus f32 operations on the CUDA cores."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops / H100_BF16_FLOP_PER_S
             + flops_f32 / H100_F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bench_graphs(seed, n_nodes, deg, n_slots, e_slots):
    """``bench.py``'s graphs: B random graphs, every node with ``deg``
    distinct in-neighbours, features from a numpy seed."""
    rng = np.random.default_rng(seed)
    adjs, efs, nfs = [], [], []
    for _ in range(B):
        adj = np.zeros((n_nodes, n_nodes), np.int64)
        for r in range(n_nodes):
            adj[rng.choice(n_nodes, size=deg, replace=False), r] = 1
        adjs.append(adj)
        efs.append(rng.normal(size=(n_nodes * deg, D)).astype(np.float32))
        nfs.append(rng.normal(size=(n_nodes, D)).astype(np.float32))
    gf = rng.normal(size=(B, D)).astype(np.float32)
    return {"graphs": adjs, "ef": efs, "nf": nfs, "gf": gf}


def check_edge_update(torch, eu, g, seed):
    """Kernel 1 against its plain version on the layout of ``g``."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    ef = g.ef.to(torch.bfloat16)
    ln = {"scale": 1 + 0.1 * rnd(D), "bias": 0.1 * rnd(D)}
    w0 = (rnd(D, D) * D ** -0.5).to(torch.bfloat16)
    ts, tr, tg, b = rnd(N, D), rnd(N, D), rnd(G, D), rnd(D)
    args = (ef, ln, w0, ts, tr, tg, b, g.senders, g.receivers,
            *g.slot_shape)
    h, agg = eu.fused_edge_update_agg(*args)
    h_ref, _ = eu.fused_edge_update_agg_plain(
        ef, ln["scale"], ln["bias"], w0, ts, tr, tg, b, g.senders,
        g.receivers, g.slot_shape[1])
    torch.cuda.synchronize()
    own = torch.zeros_like(agg).index_add_(0, g.receivers, h.float())
    err_h = float((h.float() - h_ref.float()).abs().max())
    err_agg = float((agg - own).abs().max())
    # h: one bf16 ulp at the largest magnitude (the products accumulate in
    # another order, so a value near a rounding boundary may round the
    # other way); agg: f32 sums of the same rounded h in another order.
    tol_h = 2.0 ** -7 * float(h_ref.float().abs().max())
    tol_agg = 1e-5 * float(own.abs().max()) * max(1, E // N)
    ok = (err_h <= tol_h and err_agg <= tol_agg
          and bool(torch.isfinite(h.float()).all()))
    kernel = lambda: eu.fused_edge_update_agg(*args)
    plain = lambda: eu.fused_edge_update_agg_plain(
        ef, ln["scale"], ln["bias"], w0, ts, tr, tg, b, g.senders,
        g.receivers, g.slot_shape[1])
    times = {"kernel_ms": graph_ms(torch, kernel),
             "plain_ms": graph_ms(torch, plain),
             "kernel_call_ms": cuda_ms(torch, kernel),
             "plain_call_ms": cuda_ms(torch, plain)}
    nbytes = (E * D * 2 + D * D * 2 + 2 * N * D * 4 + G * D * 4 + D * 4
              + 2 * D * 4 + 2 * E * 4 + E * D * 2 + N * D * 4)
    bms, by = bound_ms(nbytes, 2 * E * D * D)
    return {"shape": f"E={E} N={N} G={G} d={D} pad_aliases_real="
                     f"{g.pad_aliases_real}",
            "max_err": err_h, "tol": tol_h, "agg_max_err": err_agg,
            "agg_tol": tol_agg, "ok": ok, **times, "bound_ms": bms,
            "bound_by": by}


def check_ffn(torch, ffn, T, seed):
    """Kernel 2 against its plain version at T rows of width D."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    x, extra = rnd(T, D).to(bf), rnd(T, D).to(bf)
    w = (1 + 0.1 * rnd(D), 0.1 * rnd(D),
         (rnd(D, 4 * D) * D ** -0.5).to(bf), (0.1 * rnd(4 * D)).to(bf),
         (rnd(4 * D, D) * (4 * D) ** -0.5).to(bf), (0.1 * rnd(D)).to(bf))
    y = ffn.ln_ffn_residual(x, *w, extra=extra)
    ref = ffn.ln_ffn_residual_plain(x, *w, extra=extra)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    # Two bf16 ulps at the largest magnitude: the final rounding, plus a
    # hidden value that rounds the other way after a differently ordered
    # f32 sum.
    tol = 2.0 ** -6 * float(ref.float().abs().max())
    kernel = lambda: ffn.ln_ffn_residual(x, *w, extra=extra)
    plain = lambda: ffn.ln_ffn_residual_plain(x, *w, extra=extra)
    times = {"kernel_ms": graph_ms(torch, kernel),
             "plain_ms": graph_ms(torch, plain),
             "kernel_call_ms": cuda_ms(torch, kernel),
             "plain_call_ms": cuda_ms(torch, plain)}
    nbytes = 3 * T * D * 2 + 2 * D * 4 * D * 2 + (2 * D + 4 * D + D) * 4
    bms, by = bound_ms(nbytes, 4 * T * D * 4 * D)
    return {"shape": f"T={T} d={D}", "max_err": err, "tol": tol,
            "ok": err <= tol and bool(torch.isfinite(y.float()).all()),
            **times, "bound_ms": bms, "bound_by": by}


def timed(torch, kernel, plain, library=None):
    """Device times (CUDA-graph replay) and eager per-call times of a
    kernel and its plain version, and the device time of the one PyTorch
    call that computes the same function, where there is one."""
    out = {"kernel_ms": graph_ms(torch, kernel),
           "plain_ms": graph_ms(torch, plain),
           "kernel_call_ms": cuda_ms(torch, kernel),
           "plain_call_ms": cuda_ms(torch, plain), "library_ms": None}
    if library is not None:
        out["library_ms"] = graph_ms(torch, library)
    return out


def max_err(a, ref):
    return float((a.float() - ref.float()).abs().max())


def check_edge_update_h(torch, eu, g, seed):
    """The non-agg edge update (the training route's) against its plain
    version on the layout of ``g``: one bf16 ulp at the largest
    magnitude."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    ef = g.ef.to(torch.bfloat16)
    ln = {"scale": 1 + 0.1 * rnd(D), "bias": 0.1 * rnd(D)}
    w0 = (rnd(D, D) * D ** -0.5).to(torch.bfloat16)
    ts, tr, tg, b = rnd(N, D), rnd(N, D), rnd(G, D), rnd(D)
    kernel = lambda: eu.fused_edge_update(ef, ln, w0, ts, tr, tg, b,
                                          g.senders, g.receivers,
                                          *g.slot_shape)
    plain = lambda: eu.fused_edge_update_plain(
        ef, ln["scale"], ln["bias"], w0, ts, tr, tg, b, g.senders,
        g.receivers, g.slot_shape[1])
    with torch.no_grad():
        h, h_ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max_err(h, h_ref)
        tol = 2.0 ** -7 * float(h_ref.float().abs().max())
        times = timed(torch, kernel, plain)
    nbytes = (E * D * 2 + D * D * 2 + 2 * N * D * 4 + G * D * 4 + D * 4
              + 2 * D * 4 + 2 * E * 4 + E * D * 2)
    bms, by = bound_ms(nbytes, 2 * E * D * D)
    return {"shape": f"E={E} N={N} G={G} d={D} pad_aliases_real="
                     f"{g.pad_aliases_real}", "max_err": err, "tol": tol,
            "ok": err <= tol and bool(torch.isfinite(h.float()).all()),
            **times, "bound_ms": bms, "bound_by": by}


def check_segment_sums(torch, ss, g, seed):
    """The sorted (receivers) and windowed (senders) sums of an [E, D]
    bf16 input into the N node segments of ``g``, against their plain
    versions: one bf16 ulp at the largest magnitude.  ``library_ms``:
    ``index_add_`` of the f32 widening of x into a zeroed f32 buffer."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
    x = torch.randn(E, D, generator=gen, device=dev).to(torch.bfloat16)
    xf = x.float()
    ns, es = g.slot_shape
    gi = torch.arange(G + 1, dtype=torch.int32, device=dev)
    wins = (gi * ns, gi * es)
    cases = {}
    for name, ids, kernel, plain in (
            ("sorted", g.receivers,
             lambda: ss.sorted_segment_sum(x, g.receivers, N),
             lambda: ss.sorted_segment_sum_plain(x, g.receivers, N)),
            ("windowed", g.senders,
             lambda: ss.windowed_segment_sum(x, g.senders, N, *wins),
             lambda: ss.windowed_segment_sum_plain(x, g.senders, N,
                                                   *wins))):
        ids_long = ids.long()
        library = lambda: torch.zeros(N, D, device=dev).index_add_(
            0, ids_long, xf)
        with torch.no_grad():
            out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        nbytes = E * D * 2 + E * 4 + N * D * 2 + (
            2 * (G + 1) * 4 if name == "windowed" else 0)
        bms, by = bound_ms(nbytes, 0, flops_f32=E * D)
        cases[name] = {"shape": f"{name} E={E} N={N} d={D} bf16",
                       "max_err": err, "tol": tol,
                       "ok": err <= tol and bool(torch.isfinite(
                           out.float()).all()),
                       **timed(torch, kernel, plain, library),
                       "bound_ms": bms, "bound_by": by}
    return cases


def check_gather(torch, ga, g, seed):
    """The sorted gather of an [N, D] bf16 table by the receivers:
    bit-equal to its plain version.  ``library_ms``: ``index_select``."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N = g.num_edge_slots, g.num_node_slots
    table = torch.randn(N, D, generator=gen, device=dev).to(torch.bfloat16)
    idx_long = g.receivers.long()
    kernel = lambda: ga.sorted_gather(table, g.receivers)
    plain = lambda: ga.sorted_gather_plain(table, g.receivers)
    with torch.no_grad():
        out, ref = kernel(), plain()
    torch.cuda.synchronize()
    bms, by = bound_ms(N * D * 2 + E * 4 + E * D * 2, 0)
    return {"shape": f"table [{N}, {D}] bf16 -> {E} rows",
            "max_err": max_err(out, ref), "tol": 0.0,
            "ok": bool(torch.equal(out, ref)),
            **timed(torch, kernel, plain,
                    lambda: table.index_select(0, idx_long)),
            "bound_ms": bms, "bound_by": by}


def check_ln_backward(torch, ll, lnp, T, seed):
    """The LN->matmul backward at T rows, d = dout = D: dx within 2^-6 and
    dW, dscale, dbias within 1e-3 of their largest magnitudes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    args = (rnd(T, D).to(bf), 1 + 0.1 * rnd(D), 0.1 * rnd(D),
            (rnd(D, D) * D ** -0.5).to(bf), rnd(T, D).to(bf))
    kernel = lambda: ll.ln_linear_backward(*args)
    plain = lambda: lnp.ln_linear_backward_plain(*args)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    names = ("dx", "dscale", "dbias", "dw")
    rel = {n: max_err(o, r) / max(float(r.float().abs().max()), 1e-30)
           for n, o, r in zip(names, out, ref)}
    tols = dict(zip(names, (2.0 ** -6, 1e-3, 1e-3, 1e-3)))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in out)
    nbytes = 3 * T * D * 2 + D * D * 2 + 2 * D * 4 + D * D * 4 + 2 * D * 4
    bms, by = bound_ms(nbytes, 4 * T * D * D)
    return {"shape": f"T={T} d={D} dout={D}",
            "max_err": max(max_err(o, r) for o, r in zip(out, ref)),
            "rel_err": rel, "tol": tols,
            "ok": finite and all(rel[n] <= tols[n] for n in names),
            **timed(torch, kernel, plain), "bound_ms": bms,
            "bound_by": by}


def kernel_entry(name, source, replaces, launches, cases):
    """One kernel's line entry; its times are those of the heaviest case
    (the first), and every case is listed under ``cases``.  ``ms`` and
    ``plain_ms`` are device times (CUDA-graph replay); the ``*_call_ms``
    of each case include the eager host cost of a call."""
    head = cases[0]
    err = max(c["max_err"] for c in cases)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "max_err": err, "tol": head["tol"],
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"), "cases": cases}


def train_phase(torch, pt, g, zero_counts, read_counts):
    """Phase 4b: ``benchmarks/bench_train_step.py``'s step on ``g`` (bf16
    features), f32 master params, bf16 compute, AdamW(3e-4).  Raises
    ``SystemExit`` on a wrong launch count, a gradient off the pure route
    or a non-finite loss."""
    import copy
    rng = np.random.default_rng(1)
    E, N = g.num_edge_slots, g.num_node_slots
    target = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(device=g.device, dtype=torch.bfloat16)
    y = g.with_features(ef=target(E, D), nf=target(N, D), gf=None)
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((D, D, D), generator=gen)
                           for _ in range(N_CORES)])
    twin, twin32 = copy.deepcopy(model), copy.deepcopy(model)
    step = pt.make_train_step(model, pt.adamw(model.parameters(), 3e-4),
                              compute_dtype=torch.bfloat16)
    pure_step = pt.make_train_step(twin, pt.adamw(twin.parameters(), 3e-4),
                                   compute_dtype=torch.bfloat16)
    f32_step = pt.make_train_step(twin32,
                                  pt.adamw(twin32.parameters(), 3e-4))
    pt.enable_kernels(True)
    zero_counts()
    m = step(g, y)
    torch.cuda.synchronize()
    launches = read_counts()
    expect = {k: 0 for k in launches}
    expect.update(edge=N_CORES, segment_sum=2 * N_CORES, windowed=N_CORES,
                  gather=N_CORES, ln_backward=N_CORES)
    if launches != expect:
        raise SystemExit(f"train step did not take the kernels as expected "
                         f"({expect}): {launches}")
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    pt.enable_kernels(False)
    mp = pure_step(g, y)
    f32 = lambda t: t.float()
    f32_step(g.with_features(ef=f32(g.ef), nf=f32(g.nf), gf=f32(g.gf)),
             y.with_features(ef=f32(y.ef), nf=f32(y.nf)))
    torch.cuda.synchronize()
    pt.enable_kernels(True)
    loss, pure_loss = float(m["loss"]), float(mp["loss"])
    grads32 = dict(twin32.named_parameters())
    ratios = {}
    for n, p in twin.named_parameters():
        bound = max(5e-2 * float(p.grad.abs().max()),
                    float((p.grad - grads32[n].grad).abs().max()))
        err = float((grads[n] - p.grad).abs().max())
        ratios[n] = err / bound if bound > 0 else float(err > 0)
    worst = max((r, n) for n, r in ratios.items())
    if (abs(loss - pure_loss) > 1e-2 * abs(pure_loss) or worst[0] > 1.0
            or not all(bool(torch.isfinite(t).all()) for t in grads.values())):
        raise SystemExit(f"train step disagrees with the pure route: loss "
                         f"{loss} vs {pure_loss}, worst gradient {worst}")
    losses = [loss] + [float(step(g, y)["loss"]) for _ in range(4)]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite train loss: {losses}")
    step_ms = cuda_ms(torch, lambda: step(g, y), iters=10)
    pt.enable_kernels(False)
    pure_step_ms = cuda_ms(torch, lambda: pure_step(g, y), iters=10)
    pure_rows, pure_busy_ms, _ = profile_forward(torch,
                                                 lambda: pure_step(g, y))
    pt.enable_kernels(True)
    host_rows = []
    prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: step(g, y),
                                                  host_rows)
    host_rows.sort(reverse=True)
    return {"launches": launches, "loss": loss, "pure_loss": pure_loss,
            "worst_grad": worst, "losses": losses, "step_ms": step_ms,
            "pure_step_ms": pure_step_ms, "prof_rows": prof_rows,
            "host_rows": host_rows, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "pure_busy_ms": pure_busy_ms,
            "pure_kernels": sum(r[1] for r in pure_rows)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.ops.kernels import _build
    from graphnets_tpu_torch.ops import ln_linear as lnp
    from graphnets_tpu_torch.ops.kernels import edge_update as eu
    from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
    from graphnets_tpu_torch.ops.kernels import gather as ga
    from graphnets_tpu_torch.ops.kernels import ln_linear as ll
    from graphnets_tpu_torch.ops.kernels import segment_sum as ss

    # Every wrapper's launch count, set to 0 before and read after a path.
    counters = {"edge_agg": (eu, "LAUNCHES"), "ffn": (ffn, "LAUNCHES"),
                "edge": (eu, "LAUNCHES_NO_AGG"),
                "segment_sum": (ss, "LAUNCHES"),
                "windowed": (ss, "WINDOWED_LAUNCHES"),
                "gather": (ga, "LAUNCHES"), "ln_backward": (ll, "LAUNCHES")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")

    # 2. Build every kernel.
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(_build.kernel_names())}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. Each kernel against its plain version at the main-path shapes.
    g_exact = pt.batch(bench_graphs(0, N_PER_G, DEG, N_PER_G,
                                    N_PER_G * DEG),
                       pad=pt.PadSpec.uniform(N_PER_G, N_PER_G * DEG))
    g_padded = pt.batch(bench_graphs(1, N_PER_G - 8, DEG, N_PER_G,
                                     N_PER_G * DEG),
                        pad=pt.PadSpec.uniform(N_PER_G, N_PER_G * DEG))
    if (g_exact.slot_shape != (N_PER_G, N_PER_G * DEG)
            or g_exact.pad_aliases_real or not g_padded.pad_aliases_real):
        raise SystemExit("unexpected uniform layouts from batch()")
    edge_cases = [check_edge_update(torch, eu, g, i)
                  for i, g in enumerate((g_exact, g_padded))]
    ffn_cases = [check_ffn(torch, ffn, T, 10 + i)
                 for i, T in enumerate((B * N_PER_G * DEG, B * N_PER_G, B))]
    edge_h_cases = [check_edge_update_h(torch, eu, g, 20 + i)
                    for i, g in enumerate((g_exact, g_padded))]
    seg_cases = check_segment_sums(torch, ss, g_exact, 30)
    gather_case = check_gather(torch, ga, g_exact, 31)
    ln_case = check_ln_backward(torch, ll, lnp, B * N_PER_G * DEG, 32)
    checks = (edge_cases + ffn_cases + edge_h_cases
              + list(seg_cases.values()) + [gather_case, ln_case])
    for c in checks:
        log("check: " + json.dumps(c))
    failed = [c["shape"] for c in checks if not c["ok"]]
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")

    # 4. The main path, through the entry points a user calls.
    g = g_exact.with_features(ef=g_exact.ef.to(torch.bfloat16),
                              nf=g_exact.nf.to(torch.bfloat16),
                              gf=g_exact.gf.to(torch.bfloat16))
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((D, D, D), generator=gen)
                           for _ in range(N_CORES)]).to(torch.bfloat16)
    pt.enable_kernels(True)
    with torch.no_grad():
        zero_counts()
        y = model(g)
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"main path launches: {launches}")
        expect = {k: 0 for k in counters}
        expect.update(edge_agg=N_CORES, ffn=3 * N_CORES)
        if launches != expect:
            raise SystemExit(f"main path did not take the kernels as "
                             f"expected ({expect}): {launches}")
        fwd_ms = cuda_ms(torch, lambda: model(g), iters=10)
        fwd_graph_ms = graph_ms(torch, lambda: model(g), iters=10)
        prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: model(g))
        pt.enable_kernels(False)
        y_pure = model(g)
        pure_ms = cuda_ms(torch, lambda: model(g), iters=10)
        pure_graph_ms = graph_ms(torch, lambda: model(g), iters=10)
        pt.enable_kernels(True)
    out, ref = pt.unbatch(y), pt.unbatch(y_pure)
    # test_gncore_fused_matches_pure holds the f32 routes to rtol 1e-4;
    # in bf16 (8-bit mantissa) three cores of differently rounded residual
    # sums are held to 5e-2 of the largest magnitude of each feature set.
    path_err = {}
    for key in ("ef", "nf", "gf"):
        a, r = np.asarray(out[key], np.float32), np.asarray(ref[key],
                                                            np.float32)
        if a.shape != r.shape or not np.isfinite(a).all():
            raise SystemExit(f"main path {key}: bad shape or non-finite")
        path_err[key] = float(np.abs(a - r).max() / np.abs(r).max())
    log(f"main path vs pure route (max err / max |ref|): {path_err}, "
        f"tolerance 5e-2")
    if max(path_err.values()) > 5e-2:
        raise SystemExit("main path disagrees with the pure route")
    n_edges = int(g.n_edge.sum())
    log(f"forward: {fwd_ms:.4f} ms eager ({n_edges / fwd_ms * 1e3:.4e} "
        f"edges/s), {fwd_graph_ms:.4f} ms as a CUDA graph, kernel route; "
        f"pure route {pure_ms:.4f} ms eager, {pure_graph_ms:.4f} ms as a "
        f"graph; {kind}, {card.split(',')[-1].strip()}")
    log(f"profile of one eager forward (profiler on): kernels "
        f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall; without the profiler "
        f"the device idles {1 - fwd_graph_ms / fwd_ms:.3f} of the eager "
        f"forward (1 - graph time / eager time)")
    for dev_ms, count, name in prof_rows[:10]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")

    # 4b. The headline training step, through make_train_step.
    train = train_phase(torch, pt, g, zero_counts, read_counts)
    log(f"train step launches: {train['launches']}")
    log(f"train step vs pure route: loss {train['loss']:.6f} vs "
        f"{train['pure_loss']:.6f} (tolerance 1e-2 relative); worst "
        f"gradient {train['worst_grad'][1]} at {train['worst_grad'][0]:.4f}"
        f" of its bound (max of 5e-2 x its largest magnitude and the "
        f"pure route's bf16-vs-f32 distance)")
    log(f"train losses over {len(train['losses'])} steps: "
        f"{train['losses']}")
    log(f"train step: {train['step_ms']:.4f} ms eager "
        f"({n_edges / train['step_ms'] * 1e3:.4e} edges/s), kernel route; "
        f"pure route {train['pure_step_ms']:.4f} ms; {kind}, "
        f"{card.split(',')[-1].strip()}")
    log(f"profile of one train step (profiler on): "
        f"{sum(r[1] for r in train['prof_rows'])} kernels, "
        f"{train['busy_ms']:.4f} ms of {train['wall_ms']:.4f} ms wall, busy "
        f"share {train['busy_ms'] / train['wall_ms']:.3f}; without the "
        f"profiler the device is busy "
        f"{train['busy_ms'] / train['step_ms']:.3f} of the eager step "
        f"(kernel time / eager time)")
    for dev_ms, count, name in train["prof_rows"][:15]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    log(f"profile of one pure-route train step: {train['pure_kernels']} "
        f"kernels, {train['pure_busy_ms']:.4f} ms")
    log(f"host ops of the kernel-route step by self CPU time (profiler on), "
        f"{len(train['host_rows'])} kinds:")
    for host_ms, count, name in train["host_rows"][:12]:
        log(f"  {host_ms:9.4f} ms  x{count:<4d} {name[:90]}")

    # 5. Results.
    tl = train["launches"]
    src, ref = "graphnets_tpu_torch/csrc/", "graphnets_tpu/ops/pallas/"
    kernels = [
        kernel_entry("fused_edge_update_agg", src + "edge_update.cu",
                     ref + "edge_update.py:212", launches["edge_agg"],
                     edge_cases),
        kernel_entry("ln_ffn_residual", src + "fused_ffn.cu",
                     ref + "fused_ffn.py:156", launches["ffn"], ffn_cases),
        kernel_entry("fused_edge_update", src + "edge_update.cu",
                     ref + "edge_update.py:212", tl["edge"], edge_h_cases),
        kernel_entry("sorted_segment_sum", src + "segment_sum.cu",
                     ref + "segment_sum.py:193", tl["segment_sum"],
                     [seg_cases["sorted"]]),
        kernel_entry("windowed_segment_sum", src + "segment_sum.cu",
                     ref + "segment_sum.py:193", tl["windowed"],
                     [seg_cases["windowed"]]),
        kernel_entry("sorted_gather", src + "gather.cu",
                     ref + "gather.py:226", tl["gather"], [gather_case]),
        kernel_entry("ln_linear_backward", src + "ln_linear_bwd.cu",
                     ref + "ln_linear.py:214", tl["ln_backward"], [ln_case]),
    ]
    log(json.dumps({"kernels": kernels, "forward_ms": fwd_ms,
                    "forward_graph_ms": fwd_graph_ms,
                    "pure_forward_ms": pure_ms,
                    "pure_forward_graph_ms": pure_graph_ms,
                    "device_idle_share": 1 - fwd_graph_ms / fwd_ms,
                    "profiled_kernel_ms": busy_ms,
                    "profiled_wall_ms": wall_ms,
                    "edges_per_s": n_edges / fwd_ms * 1e3,
                    "train_step_ms": train["step_ms"],
                    "pure_train_step_ms": train["pure_step_ms"],
                    "train_edges_per_s": n_edges / train["step_ms"] * 1e3,
                    "train_profiled_kernel_ms": train["busy_ms"],
                    "train_profiled_wall_ms": train["wall_ms"],
                    "train_kernels_per_step": sum(
                        r[1] for r in train["prof_rows"]),
                    "pure_train_profiled_kernel_ms": train["pure_busy_ms"],
                    "pure_train_kernels_per_step": train["pure_kernels"],
                    "train_losses": train["losses"],
                    "train_worst_grad_err": train["worst_grad"],
                    "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``graphnets_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line
(4b drives the training step; A and B drive the non-uniform route):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``graphnets_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (all sources at once) and print the build time and the
   compiler's register/spill report;
3. hold each kernel against its plain torch version on the card, at the
   shapes the main path gives it: the fused edge update on the headline
   layout and on a padded uniform layout, the fused LN->FFN->residual at
   T = 16384, 1024, 8 and 1056 rows; record the largest error against the stated
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
A. run the sort-task flagship (``examples/sort_torch.py``: encoder ->
   2 GNCores -> decoder at (384, 384, 384), batch 4, f32, AdamW(3e-4), on
   ``sort_pad_spec`` batches from the host generator: N = 41, E = 512,
   G = 5, not a uniform layout) through ``train_sort``: one step on the
   kernel route and one on the plain route (kernels off) from the same
   seed, whose losses must agree within 1e-4 relative and whose gradients
   within 1e-3 of each tensor's largest magnitude (f32 sums in another
   order); then a few more steps with the counters set to 0 just before
   and read just after: every step must launch ``ln_matmul`` twice, the
   LN backward twice (in f32), the windowed segment sum 3 times (the
   senders gather's backward in the encoder and both cores) and no other
   kernel; then
   ``sort_accuracy`` on a few batches, on both routes.  Print steps/s,
   the eager and the device time of a step and a profile;
B. run the headline model on a bucket-padded batch (``bench.py``'s eight
   graphs batched with ``PadSpec.bucketed(1024, 16384, 8,
   node_multiple=32)``: N = 1056, E = 16384, G = 9, bf16): one forward,
   which must launch ``ln_matmul`` and ``sorted_gather_add`` 3 times each
   and match the plain route within 5e-2 of each feature set's largest
   magnitude; then the train step of phase 4b on that batch, with 4b's
   limits on the loss and the gradients, and per step 3 ``ln_matmul``, 3
   ``sorted_gather_add``, 3 LN backwards, 6 sorted and 3 windowed segment
   sums and 3 sorted gathers.  The kernels of this route are held against
   their plain versions in phase 3 too: ``ln_matmul`` at [16384, 384]
   bf16 with an f32 addend and without, and at [512, 384] f32; the LN
   backward at [512, 384] f32; ``sorted_gather_add`` with a [1056, 384]
   f32 table and an f32 addend (bit-equal); the segment sums on the
   bucketed layout, whose last window holds the padding, on bf16 rows
   (the edge->node sum) and on f32 rows (the cotangents of the deferred
   receivers term and of the senders gather); the windowed sum of f32
   [512, 384] rows into the 41 node slots of a sort-task batch; the
   sorted gather from a [1056, 384] bf16 table; the fused FFN at
   T = 1056;
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


def check_segment_sums(torch, ss, g, seed, dtype=None,
                       which=("sorted", "windowed")):
    """The sorted (receivers) and windowed (senders) sums of an [E, D]
    input (bf16, or ``dtype``) into the N node segments of ``g``, against
    their plain versions: one bf16 ulp at the largest magnitude, or 1e-5
    of it for f32 rows (an f32 sum in another order).  The windows are the
    model's (``searchsorted`` of the graph ids), so on a bucketed batch
    the last one holds the padding.  ``library_ms``: ``index_add_`` of the
    f32 widening of x into a zeroed f32 buffer."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N, G = g.num_edge_slots, g.num_node_slots, g.num_graph_slots
    dtype = dtype or torch.bfloat16
    es = 2 if dtype == torch.bfloat16 else 4
    x = torch.randn(E, D, generator=gen, device=dev).to(dtype)
    xf = x.float()
    gi = torch.arange(G + 1, dtype=torch.int32, device=dev)
    wins = (torch.searchsorted(g.node_graph, gi).to(torch.int32),
            torch.searchsorted(g.edge_graph, gi).to(torch.int32))
    counts = {"sorted": "LAUNCHES", "windowed": "WINDOWED_LAUNCHES"}
    cases = {}
    for name, ids, kernel, plain in (
            ("sorted", g.receivers,
             lambda: ss.sorted_segment_sum(x, g.receivers, N),
             lambda: ss.sorted_segment_sum_plain(x, g.receivers, N)),
            ("windowed", g.senders,
             lambda: ss.windowed_segment_sum(x, g.senders, N, *wins),
             lambda: ss.windowed_segment_sum_plain(x, g.senders, N,
                                                   *wins))):
        if name not in which:
            continue
        ids_long = ids.long()
        library = lambda: torch.zeros(N, D, device=dev).index_add_(
            0, ids_long, xf)
        with torch.no_grad():
            before = getattr(ss, counts[name])
            out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if getattr(ss, counts[name]) != before + 1:
            raise SystemExit(f"{name}_segment_sum did not launch its kernel")
        err = max_err(out, ref)
        tol = (2.0 ** -7 if es == 2 else 1e-5) * float(ref.float().abs().max())
        nbytes = E * D * es + E * 4 + N * D * es + (
            2 * (G + 1) * 4 if name == "windowed" else 0)
        bms, by = bound_ms(nbytes, 0, flops_f32=E * D)
        cases[name] = {"shape": f"{name} E={E} N={N} G={G} d={D} "
                                f"{'bf16' if es == 2 else 'f32'}",
                       "max_err": err, "tol": tol,
                       "ok": (err <= tol and out.dtype == ref.dtype
                              and bool(torch.isfinite(out.float()).all())),
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


def check_ln_backward(torch, ll, lnp, T, seed, dtype=None):
    """The LN->matmul backward at T rows, d = dout = D.  bf16 rows: dx
    within 2^-6 and dW, dscale, dbias within 1e-3 of their largest
    magnitudes; f32 rows: all within 1e-4 (f32 sums in another order)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = dtype or torch.bfloat16
    es = 2 if bf == torch.bfloat16 else 4
    args = (rnd(T, D).to(bf), 1 + 0.1 * rnd(D), 0.1 * rnd(D),
            (rnd(D, D) * D ** -0.5).to(bf), rnd(T, D).to(bf))
    kernel = lambda: ll.ln_linear_backward(*args)
    plain = lambda: lnp.ln_linear_backward_plain(*args)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    names = ("dx", "dscale", "dbias", "dw")
    rel = {n: max_err(o, r) / max(float(r.float().abs().max()), 1e-30)
           for n, o, r in zip(names, out, ref)}
    tols = dict(zip(names, (2.0 ** -6, 1e-3, 1e-3, 1e-3) if es == 2
                    else (1e-4,) * 4))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in out)
    nbytes = 3 * T * D * es + D * D * es + 2 * D * 4 + D * D * 4 + 2 * D * 4
    flops = 4 * T * D * D
    bms, by = bound_ms(nbytes, flops if es == 2 else 0,
                       flops_f32=0 if es == 2 else flops)
    return {"shape": f"T={T} d={D} dout={D} {'bf16' if es == 2 else 'f32'}",
            "max_err": max(max_err(o, r) for o, r in zip(out, ref)),
            "rel_err": rel, "tol": tols,
            "ok": finite and all(rel[n] <= tols[n] for n in names),
            **timed(torch, kernel, plain), "bound_ms": bms,
            "bound_by": by}


def check_ln_matmul(torch, ll, lnp, T, seed, dtype, addend_dtype):
    """``ln_matmul`` at T rows, d = dout = D, against its plain version.
    bf16 rows: the completed row within one bf16 ulp at the largest
    magnitude (a normalised value may round the other way after a
    differently ordered f32 sum), the f32 partial within 1e-3 of it; f32
    rows: within 1e-4 (an f32 sum in another order).  No single PyTorch
    call computes LN, product and add, so ``library_ms`` is null."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rnd(T, D)
    x[:3] = 0.0  # var == 0 rows
    args = (x.to(dtype), 1 + 0.1 * rnd(D), 0.1 * rnd(D),
            (rnd(D, D) * D ** -0.5).to(dtype))
    addend = None if addend_dtype is None else rnd(T, D).to(addend_dtype)
    kernel = lambda: ll.ln_matmul(*args, addend=addend)
    plain = lambda: lnp.ln_matmul_reference(*args, addend=addend)
    with torch.no_grad():
        before = ll.FWD_LAUNCHES
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if ll.FWD_LAUNCHES != before + 1:
            raise SystemExit("ln_matmul did not launch its kernel")
        err = max_err(out, ref)
        if dtype == torch.float32:
            rel = 1e-4
        else:
            rel = 1e-3 if addend is None else 2.0 ** -7
        tol = rel * float(ref.float().abs().max())
        times = timed(torch, kernel, plain)
    es = x.to(dtype).element_size()
    nbytes = (T * D * es + D * D * es + 2 * D * 4 + T * D * out.element_size()
              + (0 if addend is None else T * D * addend.element_size()))
    flops = 2 * T * D * D
    bms, by = bound_ms(nbytes, flops if es == 2 else 0,
                       flops_f32=0 if es == 2 else flops)
    name = lambda t: str(t).replace("torch.", "")
    return {"shape": f"T={T} d={D} dout={D} {name(dtype)} addend="
                     f"{name(addend_dtype)}", "max_err": err, "tol": tol,
            "ok": (err <= tol and out.dtype == ref.dtype
                   and bool(torch.isfinite(out.float()).all())),
            **times, "bound_ms": bms, "bound_by": by}


def check_gather_add(torch, ga, g, seed):
    """``sorted_gather_add`` of an [N, D] f32 table by the receivers of
    ``g`` onto an [E, D] f32 addend (the deferred receivers term of the
    bucketed edge update): one f32 add of the same two values, bit-equal
    to its plain version.  No single PyTorch call computes gather and add,
    so ``library_ms`` is null."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, N = g.num_edge_slots, g.num_node_slots
    table = torch.randn(N, D, generator=gen, device=dev)
    addend = torch.randn(E, D, generator=gen, device=dev)
    kernel = lambda: ga.sorted_gather_add(table, g.receivers, addend)
    plain = lambda: ga.sorted_gather_add_plain(table, g.receivers, addend)
    with torch.no_grad():
        before = ga.ADD_LAUNCHES
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if ga.ADD_LAUNCHES != before + 1:
            raise SystemExit("sorted_gather_add did not launch its kernel")
        times = timed(torch, kernel, plain)
    bms, by = bound_ms(N * D * 4 + E * 4 + 2 * E * D * 4, 0,
                       flops_f32=E * D)
    return {"shape": f"table [{N}, {D}] f32 -> {E} rows + f32 addend",
            "max_err": max_err(out, ref), "tol": 0.0,
            "ok": bool(torch.equal(out, ref)), **times, "bound_ms": bms,
            "bound_by": by}


def kernel_entry(name, source, replaces, launches, cases):
    """One kernel's line entry; its times are those of the heaviest case
    (the first), and every case is listed under ``cases``.  ``launches``
    maps each driven path to the count read just after it (set to 0 just
    before); the entry's ``launches`` is their sum.  ``ms`` and
    ``plain_ms`` are device times (CUDA-graph replay); the ``*_call_ms``
    of each case include the eager host cost of a call."""
    head = cases[0]
    err = max(c["max_err"] for c in cases)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": err, "max_err": err, "tol": head["tol"],
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"), "cases": cases}


def forward_phase(torch, pt, g, expect, zero_counts, read_counts, what):
    """One forward of 3 GNCores at (D, D, D) with seeded bf16 params on
    ``g`` (bf16 features), counters set to 0 just before and read just
    after; the output against the pure route (kernels off) on the card,
    within 5e-2 of each feature set's largest magnitude; eager and
    CUDA-graph times of both routes and a profile of one eager forward.
    Raises ``SystemExit`` on a wrong launch count or a wrong output."""
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((D, D, D), generator=gen)
                           for _ in range(N_CORES)]).to(torch.bfloat16)
    pt.enable_kernels(True)
    with torch.no_grad():
        zero_counts()
        y = model(g)
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"{what} launches: {launches}")
        want = {k: 0 for k in launches}
        want.update(expect)
        if launches != want:
            raise SystemExit(f"{what} did not take the kernels as "
                             f"expected ({want}): {launches}")
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
            raise SystemExit(f"{what} {key}: bad shape or non-finite")
        path_err[key] = float(np.abs(a - r).max() / np.abs(r).max())
    log(f"{what} vs pure route (max err / max |ref|): {path_err}, "
        f"tolerance 5e-2")
    if max(path_err.values()) > 5e-2:
        raise SystemExit(f"{what} disagrees with the pure route")
    return {"launches": launches, "fwd_ms": fwd_ms,
            "fwd_graph_ms": fwd_graph_ms, "pure_ms": pure_ms,
            "pure_graph_ms": pure_graph_ms, "prof_rows": prof_rows,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "path_err": path_err}


def log_forward(what, fwd, n_edges, where):
    log(f"{what}: {fwd['fwd_ms']:.4f} ms eager "
        f"({n_edges / fwd['fwd_ms'] * 1e3:.4e} edges/s), "
        f"{fwd['fwd_graph_ms']:.4f} ms as a CUDA graph, kernel route; "
        f"pure route {fwd['pure_ms']:.4f} ms eager, "
        f"{fwd['pure_graph_ms']:.4f} ms as a graph; {where}")
    log(f"profile of one eager {what} (profiler on): "
        f"{sum(r[1] for r in fwd['prof_rows'])} kernels, "
        f"{fwd['busy_ms']:.4f} ms of {fwd['wall_ms']:.4f} ms wall; without "
        f"the profiler the device idles "
        f"{1 - fwd['fwd_graph_ms'] / fwd['fwd_ms']:.3f} of the eager "
        f"forward (1 - graph time / eager time)")
    for dev_ms, count, name in fwd["prof_rows"][:10]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")


def train_phase(torch, pt, g, expect, zero_counts, read_counts, what):
    """``benchmarks/bench_train_step.py``'s step on ``g`` (bf16 features),
    f32 master params, bf16 compute, AdamW(3e-4).  Raises ``SystemExit``
    on a wrong launch count, a gradient off the pure route or a non-finite
    loss."""
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
    log(f"{what} launches: {launches}")
    want = {k: 0 for k in launches}
    want.update(expect)
    if launches != want:
        raise SystemExit(f"{what} did not take the kernels as expected "
                         f"({want}): {launches}")
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
        raise SystemExit(f"{what} disagrees with the pure route: loss "
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


def log_train(what, train, n_edges, where):
    log(f"{what} vs pure route: loss {train['loss']:.6f} vs "
        f"{train['pure_loss']:.6f} (tolerance 1e-2 relative); worst "
        f"gradient {train['worst_grad'][1]} at {train['worst_grad'][0]:.4f}"
        f" of its bound (max of 5e-2 x its largest magnitude and the "
        f"pure route's bf16-vs-f32 distance)")
    log(f"{what} losses over {len(train['losses'])} steps: "
        f"{train['losses']}")
    log(f"{what}: {train['step_ms']:.4f} ms eager "
        f"({n_edges / train['step_ms'] * 1e3:.4e} edges/s), kernel route; "
        f"pure route {train['pure_step_ms']:.4f} ms; {where}")
    log(f"profile of one {what} (profiler on): "
        f"{sum(r[1] for r in train['prof_rows'])} kernels, "
        f"{train['busy_ms']:.4f} ms of {train['wall_ms']:.4f} ms wall, busy "
        f"share {train['busy_ms'] / train['wall_ms']:.3f}; without the "
        f"profiler the device is busy "
        f"{train['busy_ms'] / train['step_ms']:.3f} of the eager step "
        f"(kernel time / eager time)")
    for dev_ms, count, name in train["prof_rows"][:15]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    log(f"profile of one pure-route {what}: {train['pure_kernels']} "
        f"kernels, {train['pure_busy_ms']:.4f} ms")
    log(f"host ops of the kernel-route {what} by self CPU time (profiler "
        f"on), {len(train['host_rows'])} kinds:")
    for host_ms, count, name in train["host_rows"][:12]:
        log(f"  {host_ms:9.4f} ms  x{count:<4d} {name[:90]}")


SORT_STEPS, SORT_EVAL_BATCHES = 30, 4


def sort_phase(torch, pt, zero_counts, read_counts):
    """Phase A: the sort flagship through ``train_sort`` and
    ``sort_accuracy`` at full width, in f32.  Raises ``SystemExit`` on a
    wrong launch count, a first step off the plain route, a non-finite
    loss or accuracies that differ between the routes."""
    cfg = pt.SortTaskConfig()
    run = lambda steps: pt.train_sort(steps=steps, cfg=cfg,
                                      core_dims=(D, D, D), n_cores=2,
                                      learning_rate=3e-4, seed=0)
    # One step on each route from the same seed: the same init (a seeded
    # host generator) and the same first batch.
    pt.enable_kernels(True)
    zero_counts()
    first = run(1)
    first_launches = read_counts()
    pt.enable_kernels(False)
    plain = run(1)
    pt.enable_kernels(True)
    torch.cuda.synchronize()
    loss, plain_loss = first.metrics["loss"], plain.metrics["loss"]
    worst = (0.0, "")
    for (n, p), q in zip(first.model.named_parameters(),
                         plain.model.parameters()):
        if p.numel():
            rel = float((p.grad - q.grad).abs().max()) / max(
                float(q.grad.abs().max()), 1e-30)
            worst = max(worst, (rel, n))
    log(f"sort step 1 vs plain route: loss {loss:.7f} vs {plain_loss:.7f} "
        f"(tolerance 1e-4 relative); worst gradient {worst[1]} off by "
        f"{worst[0]:.3e} of its largest magnitude (tolerance 1e-3)")
    if (not np.isfinite(loss) or worst[0] > 1e-3
            or abs(loss - plain_loss) > 1e-4 * abs(plain_loss)):
        raise SystemExit("sort step disagrees with the plain route")

    zero_counts()
    res = run(SORT_STEPS)
    launches = read_counts()
    log(f"sort train launches over {SORT_STEPS} steps: {launches} (first "
        f"step alone: {first_launches})")
    want = {k: 0 for k in launches}
    # Per step: the two cores' ln_matmul and LN backward, and the windowed
    # sum behind the senders gather of the encoder and of each core (512
    # rows of width 384 pass its gate; the decoder's width 2 does not).
    want.update(ln_matmul=2 * SORT_STEPS, ln_backward=2 * SORT_STEPS,
                windowed=3 * SORT_STEPS)
    one = {k: v // SORT_STEPS for k, v in want.items()}
    if launches != want or first_launches != one:
        raise SystemExit(f"train_sort did not launch ln_matmul and the LN "
                         f"backward twice a step, the windowed sum 3 times "
                         f"and nothing else: {launches}, first step "
                         f"{first_launches}")
    if not all(np.isfinite(v) for v in res.metrics.values()):
        raise SystemExit(f"non-finite sort metrics: {res.metrics}")

    zero_counts()
    acc = pt.sort_accuracy(res.model, cfg, num_batches=SORT_EVAL_BATCHES)
    eval_launches = read_counts()
    pt.enable_kernels(False)
    plain_acc = pt.sort_accuracy(res.model, cfg,
                                 num_batches=SORT_EVAL_BATCHES)
    pt.enable_kernels(True)
    log(f"sort accuracy after {SORT_STEPS} steps: {acc}; plain route "
        f"{plain_acc}; launches {eval_launches}")
    want = {k: 0 for k in eval_launches}
    want.update(ln_matmul=2 * SORT_EVAL_BATCHES)
    # An argmax over two logits may flip where they are within rounding:
    # the routes' slot accuracies are held to 0.02 of each other, and the
    # whole-graph accuracy to one graph of a batch.
    slack = dict(node_acc=0.02, edge_acc=0.02,
                 graph_acc=1.0 / cfg.batch_size)
    if (eval_launches != want
            or not all(0.0 <= v <= 1.0 for v in acc.values())
            or any(abs(acc[k] - plain_acc[k]) > slack[k] for k in acc)):
        raise SystemExit("sort_accuracy is off the plain route or did not "
                         "launch ln_matmul twice a batch")

    # The step alone (no host generation): eager and device time.
    x, y = pt.get_batch(np.random.default_rng(0), cfg)
    step = pt.make_train_step(res.model, res.optimizer)
    step_ms = cuda_ms(torch, lambda: step(x, y), iters=10)
    prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: step(x, y))
    pt.enable_kernels(False)
    pure_step_ms = cuda_ms(torch, lambda: step(x, y), iters=10)
    pure_rows, pure_busy_ms, _ = profile_forward(torch, lambda: step(x, y))
    pt.enable_kernels(True)
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: res.model(x), iters=10)
        fwd_graph_ms = graph_ms(torch, lambda: res.model(x), iters=10)
    return {"launches": launches, "first_launches": first_launches,
            "eval_launches": eval_launches, "loss": loss,
            "plain_loss": plain_loss, "worst_grad": worst,
            "metrics": res.metrics, "steps_per_sec": res.steps_per_sec,
            "acc": acc,
            "plain_acc": plain_acc, "step_ms": step_ms,
            "pure_step_ms": pure_step_ms, "busy_ms": busy_ms,
            "wall_ms": wall_ms, "prof_rows": prof_rows,
            "kernels_per_step": sum(r[1] for r in prof_rows),
            "pure_busy_ms": pure_busy_ms,
            "pure_kernels_per_step": sum(r[1] for r in pure_rows),
            "fwd_ms": fwd_ms, "fwd_graph_ms": fwd_graph_ms}


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
                "gather": (ga, "LAUNCHES"), "ln_backward": (ll, "LAUNCHES"),
                "ln_matmul": (ll, "FWD_LAUNCHES"),
                "gather_add": (ga, "ADD_LAUNCHES")}

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
    where = f"{kind}, {card.split(',')[-1].strip()}"
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
    # The same eight graphs, bucket-padded: one padding graph owns the 32
    # padding nodes; no uniform slot layout.
    g_bucket = pt.batch(bench_graphs(0, N_PER_G, DEG, N_PER_G,
                                     N_PER_G * DEG),
                        pad=pt.PadSpec.bucketed(B * N_PER_G,
                                                B * N_PER_G * DEG, B,
                                                node_multiple=32))
    if ((g_bucket.num_node_slots, g_bucket.num_edge_slots,
         g_bucket.num_graph_slots) != (1056, 16384, 9)
            or g_bucket.slot_shape is not None):
        raise SystemExit("unexpected bucketed layout from batch()")
    # A sort-task batch (N = 41, E = 512, G = 5), for the windowed sum
    # behind its senders gather.
    g_sort, _ = pt.get_batch(np.random.default_rng(0), pt.SortTaskConfig())
    if ((g_sort.num_node_slots, g_sort.num_edge_slots,
         g_sort.num_graph_slots) != (41, 512, 5)):
        raise SystemExit("unexpected sort-task layout from get_batch()")
    T_E, T_SORT = B * N_PER_G * DEG, 512
    edge_cases = [check_edge_update(torch, eu, g, i)
                  for i, g in enumerate((g_exact, g_padded))]
    ffn_cases = [check_ffn(torch, ffn, T, 10 + i)
                 for i, T in enumerate((T_E, B * N_PER_G, B,
                                        g_bucket.num_node_slots))]
    edge_h_cases = [check_edge_update_h(torch, eu, g, 20 + i)
                    for i, g in enumerate((g_exact, g_padded))]
    seg_cases = check_segment_sums(torch, ss, g_exact, 30)
    seg_bucket = check_segment_sums(torch, ss, g_bucket, 33)
    # f32 rows: the cotangents that the bucketed step's deferred receivers
    # term and senders gather scatter back, and the sort task's.
    seg_bucket32 = check_segment_sums(torch, ss, g_bucket, 39, torch.float32)
    seg_sort32 = check_segment_sums(torch, ss, g_sort, 40, torch.float32,
                                    which=("windowed",))
    gather_cases = [check_gather(torch, ga, g_exact, 31),
                    check_gather(torch, ga, g_bucket, 41)]
    ln_cases = [check_ln_backward(torch, ll, lnp, T_E, 32),
                check_ln_backward(torch, ll, lnp, T_SORT, 34,
                                  torch.float32)]
    bf, f32 = torch.bfloat16, torch.float32
    lnm_cases = [check_ln_matmul(torch, ll, lnp, T_E, 35, bf, f32),
                 check_ln_matmul(torch, ll, lnp, T_E, 36, bf, None),
                 check_ln_matmul(torch, ll, lnp, T_SORT, 37, f32, f32)]
    gather_add_case = check_gather_add(torch, ga, g_bucket, 38)
    checks = (edge_cases + ffn_cases + edge_h_cases
              + list(seg_cases.values()) + list(seg_bucket.values())
              + list(seg_bucket32.values()) + list(seg_sort32.values())
              + gather_cases + ln_cases + lnm_cases + [gather_add_case])
    for c in checks:
        log("check: " + json.dumps(c))
    failed = [c["shape"] for c in checks if not c["ok"]]
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")

    # 4. The main path, through the entry points a user calls.
    as_bf16 = lambda t: t.with_features(ef=t.ef.to(bf), nf=t.nf.to(bf),
                                        gf=t.gf.to(bf))
    g = as_bf16(g_exact)
    n_edges = int(g.n_edge.sum())
    fwd = forward_phase(torch, pt, g, dict(edge_agg=N_CORES,
                                           ffn=3 * N_CORES),
                        zero_counts, read_counts, "main path")
    log_forward("forward", fwd, n_edges, where)

    # 4b. The headline training step, through make_train_step.
    train = train_phase(
        torch, pt, g, dict(edge=N_CORES, segment_sum=2 * N_CORES,
                           windowed=N_CORES, gather=N_CORES,
                           ln_backward=N_CORES),
        zero_counts, read_counts, "train step")
    log_train("train step", train, n_edges, where)

    # A. The sort flagship: train_sort and sort_accuracy, f32.
    sort = sort_phase(torch, pt, zero_counts, read_counts)
    log(f"sort training: {sort['steps_per_sec']:.4f} steps/s over "
        f"{SORT_STEPS - 1} steps with the host generator, kernel route "
        f"(metrics {sort['metrics']}); the step alone "
        f"{sort['step_ms']:.4f} ms eager (pure route "
        f"{sort['pure_step_ms']:.4f} ms), {sort['kernels_per_step']} "
        f"kernels of {sort['busy_ms']:.4f} ms, busy share "
        f"{sort['busy_ms'] / sort['step_ms']:.3f} (kernel time / eager "
        f"time); pure route {sort['pure_kernels_per_step']} kernels of "
        f"{sort['pure_busy_ms']:.4f} ms; forward {sort['fwd_ms']:.4f} ms "
        f"eager, {sort['fwd_graph_ms']:.4f} ms as a CUDA graph; {where}")
    for dev_ms, count, name in sort["prof_rows"][:10]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")

    # B. The headline model on the bucket-padded batch.
    gb = as_bf16(g_bucket)
    bfwd = forward_phase(
        torch, pt, gb, dict(ln_matmul=N_CORES, gather_add=N_CORES,
                            segment_sum=N_CORES, ffn=2 * N_CORES),
        zero_counts, read_counts, "bucketed forward")
    log_forward("bucketed forward", bfwd, n_edges, where)
    btrain = train_phase(
        torch, pt, gb, dict(ln_matmul=N_CORES, gather_add=N_CORES,
                            ln_backward=N_CORES, segment_sum=2 * N_CORES,
                            windowed=N_CORES, gather=N_CORES),
        zero_counts, read_counts, "bucketed train step")
    log_train("bucketed train step", btrain, n_edges, where)

    # 5. Results.
    paths = {"forward": fwd["launches"], "train_step": train["launches"],
             "sort_train_step": sort["first_launches"],
             "bucketed_forward": bfwd["launches"],
             "bucketed_train_step": btrain["launches"]}
    by_path = lambda key: {p: c[key] for p, c in paths.items()}
    src, ref = "graphnets_tpu_torch/csrc/", "graphnets_tpu/ops/pallas/"
    kernels = [
        kernel_entry("fused_edge_update_agg", src + "edge_update.cu",
                     ref + "edge_update.py:212", by_path("edge_agg"),
                     edge_cases),
        kernel_entry("ln_ffn_residual", src + "fused_ffn.cu",
                     ref + "fused_ffn.py:156", by_path("ffn"), ffn_cases),
        kernel_entry("fused_edge_update", src + "edge_update.cu",
                     ref + "edge_update.py:212", by_path("edge"),
                     edge_h_cases),
        kernel_entry("sorted_segment_sum", src + "segment_sum.cu",
                     ref + "segment_sum.py:193", by_path("segment_sum"),
                     [seg_cases["sorted"], seg_bucket["sorted"],
                      seg_bucket32["sorted"]]),
        kernel_entry("windowed_segment_sum", src + "segment_sum.cu",
                     ref + "segment_sum.py:193", by_path("windowed"),
                     [seg_cases["windowed"], seg_bucket["windowed"],
                      seg_bucket32["windowed"], seg_sort32["windowed"]]),
        kernel_entry("sorted_gather", src + "gather.cu",
                     ref + "gather.py:226", by_path("gather"),
                     gather_cases),
        kernel_entry("ln_linear_backward", src + "ln_linear_bwd.cu",
                     ref + "ln_linear.py:214", by_path("ln_backward"),
                     ln_cases),
        kernel_entry("ln_matmul", src + "ln_linear_fwd.cu",
                     ref + "ln_linear.py:143", by_path("ln_matmul"),
                     lnm_cases),
        kernel_entry("sorted_gather_add", src + "gather.cu",
                     ref + "gather.py:226", by_path("gather_add"),
                     [gather_add_case]),
    ]
    slim = lambda d: {k: v for k, v in d.items()
                      if k not in ("prof_rows", "host_rows")}
    log(json.dumps({"kernels": kernels, "forward_ms": fwd["fwd_ms"],
                    "forward_graph_ms": fwd["fwd_graph_ms"],
                    "pure_forward_ms": fwd["pure_ms"],
                    "pure_forward_graph_ms": fwd["pure_graph_ms"],
                    "device_idle_share":
                        1 - fwd["fwd_graph_ms"] / fwd["fwd_ms"],
                    "profiled_kernel_ms": fwd["busy_ms"],
                    "profiled_wall_ms": fwd["wall_ms"],
                    "edges_per_s": n_edges / fwd["fwd_ms"] * 1e3,
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
                    "sort": slim(sort), "bucketed_forward": slim(bfwd),
                    "bucketed_train_step": slim(btrain),
                    "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``graphnets_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line:

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
   eager per-call time with its host cost;
4. run the main path: the headline forward of ``bench.py`` (8 graphs x 128
   nodes x in-degree 16, E = 16384, batched with
   ``PadSpec.uniform(128, 2048)``; 3 GNCores at (384, 384, 384); bf16
   activations and seeded bf16 params) with the launch counters set to 0
   just before and read just after: it must launch the edge kernel 3 times
   and the FFN kernel 9 times.  The output must be finite and match the
   same model on the pure route (kernels off) on the card.  Print the
   forward time (eager, and replayed as a CUDA graph), edges/s, and a
   profile of one eager forward (device time by kernel, idle share);
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


def profile_forward(torch, fn):
    """Device time by kernel name over one call of ``fn``
    (``torch.profiler``), the summed device time and the host wall time."""
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
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows), wall_ms


def bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
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
            "bound_by": head["bound_by"], "library_ms": None,
            "cases": cases}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.ops.kernels import _build
    from graphnets_tpu_torch.ops.kernels import edge_update as eu
    from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn

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
    for c in edge_cases + ffn_cases:
        log("check: " + json.dumps(c))
    failed = [c["shape"] for c in edge_cases + ffn_cases if not c["ok"]]
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
        eu.LAUNCHES = ffn.LAUNCHES = 0
        y = model(g)
        torch.cuda.synchronize()
        launches = {"edge": eu.LAUNCHES, "ffn": ffn.LAUNCHES}
        log(f"main path launches: {launches}")
        if launches != {"edge": N_CORES, "ffn": 3 * N_CORES}:
            raise SystemExit(f"main path did not take the kernels as "
                             f"expected ({N_CORES} edge, {3 * N_CORES} "
                             f"FFN launches): {launches}")
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

    # 5. Results.
    kernels = [
        kernel_entry("fused_edge_update_agg", "graphnets_tpu_torch/csrc/"
                     "edge_update.cu", "graphnets_tpu/ops/pallas/"
                     "edge_update.py:212", launches["edge"], edge_cases),
        kernel_entry("ln_ffn_residual", "graphnets_tpu_torch/csrc/"
                     "fused_ffn.cu", "graphnets_tpu/ops/pallas/"
                     "fused_ffn.py:156", launches["ffn"], ffn_cases),
    ]
    log(json.dumps({"kernels": kernels, "forward_ms": fwd_ms,
                    "forward_graph_ms": fwd_graph_ms,
                    "pure_forward_ms": pure_ms,
                    "pure_forward_graph_ms": pure_graph_ms,
                    "device_idle_share": 1 - fwd_graph_ms / fwd_ms,
                    "profiled_kernel_ms": busy_ms,
                    "profiled_wall_ms": wall_ms,
                    "edges_per_s": n_edges / fwd_ms * 1e3, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``graphnets_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the smoke run below
    python3 chip_smoke.py --phase gates     # the training-gate timings
    python3 chip_smoke.py --phase flagship  # the flagship recipe's accuracy
    python3 chip_smoke.py --phase flagship --seeds 0,1,2  # constant, by seed
    python3 chip_smoke.py --phase G         # phase G alone
    python3 chip_smoke.py --phase F         # phase F alone, with its kernels
    python3 chip_smoke.py --phase sums      # the segment sums, then A and S
    python3 chip_smoke.py --phase adamw     # the optimizer's one-launch AdamW
    python3 chip_smoke.py --phase split     # GraphCast's split edge layer

A ``--phase`` run builds the kernels, runs that phase alone and prints its
JSON, with no kernels line and no ``ok`` line (``--phase F`` also runs
phase 2's checks and holds the f32 FFN pair at phase 3's f32 shapes;
``--phase sums`` holds the segment sums at phase 3's layouts and the
senders' fallback on one large graph, then runs phases A and S and prints
their captured steps).

Phases, in order; any failure exits non-zero without the final ``ok`` line
(4b drives the training step; A and B drive the non-uniform route, S the
sort flagship's device loop; C and D the single large graph, forward,
training and sampled training, F the default f32 precision between them;
R the random gather):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``graphnets_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (all sources at once) and print the build time and the
   compiler's register/spill report; every instance of the ``wgmma`` / TMA
   kernels (the fused FFN forward and backward, the LN->matmul backward's
   two passes, the core of both fused edge updates and of ``ln_matmul``'s
   bf16 rows) and of the fused FFN pair's f32 kernels must show 0 spill
   bytes, and the f32 kernels' SASS (``cuobjdump``) FFMA and no matrix
   instruction of any type (no TF32);
3. hold each kernel against its plain torch version on the card, at the
   shapes the main path gives it: the fused edge update on the headline
   layout and on a padded uniform layout, and at de = dout = 512 (16
   graphs of 64 / 1024 slots, a width the JAX gate admits), each variant
   launched twice and bit-equal; the fused LN->FFN->residual at
   T = 16384, 1024, 8 and 1056 rows; record the largest error against the stated
   tolerance, and time kernel and plain version with CUDA events
   (warm-up excluded): device time from a replayed CUDA graph, and the
   eager per-call time with its host cost.  The training kernels likewise:
   the non-agg edge update, the sorted and windowed segment sums
   ([16384, 384] bf16 into 1024 segments), the sorted gather ([1024, 384]
   to 16384 rows, bit-equal) and the LN->matmul backward (T = 16384,
   d = dout = 384), with the time of one PyTorch call computing the same
   function where there is one (``index_add_``, ``index_select``).  The
   LN->matmul backward and the fused FFN forward launch twice on the same
   inputs and must be bit-equal, and the LN backward's tensor-core passes
   are timed one by one (row pass, dW pass, its fused reduction);
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
   one step.  Then the same step captured as a CUDA graph
   (``capture_step``, the port's ``jax.jit``) against the eager step from
   the same state on the same batch: loss within 1e-5 relative, every
   parameter after the step within 1e-5 of its largest magnitude plus a
   tenth of the learning rate, ten finite replays; print both times;
A. run the sort-task flagship (``examples/sort_torch.py``: encoder ->
   2 GNCores -> decoder at (384, 384, 384), batch 4, f32, AdamW(3e-4), on
   ``sort_pad_spec`` batches from the host generator: N = 41, E = 512,
   G = 5, not a uniform layout) through ``train_sort``, whose step is
   captured as a CUDA graph and replayed (the counters count the calls
   that pass through the wrappers: its warm-ups and its capture): one
   step on the
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
S. run the sort flagship as the JAX package runs it by default
   (``examples/sort.py`` without ``--host-loop``): ``train_sort_device`` at
   A's full width (f32, batch 4, AdamW(3e-4)) for 3 chunks of 200 steps,
   each step drawing its batch on the card (``device_batch``) inside the
   step captured as a CUDA graph, the metrics summed on the card and read
   once a chunk.  It checks (a) 8 device batches (and 2 in the uniform
   layout) against ``validate_graph`` and the host generator's semantics
   (``tests/test_device_data.py``); (b) one eager step on the kernel route
   against the plain route from the same state and generator state, A's
   limits (loss 1e-4 relative, gradients 1e-3 of each tensor's largest
   magnitude); (c) the launches of that step, set to 0 just before and read
   just after: ``ln_matmul`` x2, the LN backward x2, the windowed sum x3
   and nothing else; the same for its bf16 variants on both layouts
   (launches in ``S_PER_STEP``) under phase 4b's bf16 rule, with an f32
   twin on the same batch for the pure route's bf16-vs-f32 distance; (d) a
   captured chunk of 4 steps against 4 eager steps from the same state
   (the captured check's limits: mean loss 1e-5 relative, parameters 1e-5
   of their largest magnitude + 0.1 lr); (e) replays of a captured batch
   draw the batches eager calls draw from the same generator state, and
   two replays differ; the 600 steps, counted (3x a step: two warm-ups
   and the capture); (f) a checkpoint after 2 chunks restored into a fresh
   model and optimizer, then the last chunk: bit-equal to the run straight
   through; (i) the example's ``show_sample`` writes its three SVGs; (g)
   ``evaluate_sort`` (16 device batches, captured) on both routes within
   one slot a batch; (h) a chunk of 100 bf16 steps in each layout, finite.
   Print the loop's steps/s beside A's ``train_sort``, the captured step's
   time (batch generation included), the eager step, a profile of it and
   of one replay (the busy share is the replay's kernel time over the
   captured step's time).  Phase 3 holds the bf16 variants' kernels at
   their shapes: ``ln_matmul`` (f32 addend) and the LN backward on
   [512, 384] bf16 rows; on the uniform sort layout (4 graphs of 16 node /
   128 edge slots) both edge updates at d = 384, ``sorted_gather_add``
   from a [64, 384] f32 table and both segment sums on bf16 and f32 rows;
B. run the headline model on a bucket-padded batch (``bench.py``'s eight
   graphs batched with ``PadSpec.bucketed(1024, 16384, 8,
   node_multiple=32)``: N = 1056, E = 16384, G = 9, bf16): one forward,
   which must launch ``ln_matmul`` and ``sorted_gather_add`` 3 times each
   and match the plain route within 5e-2 of each feature set's largest
   magnitude; then the train step of phase 4b on that batch, with 4b's
   limits on the loss and the gradients, and per step 3 ``ln_matmul``, 3
   ``sorted_gather_add``, 3 LN backwards, 6 sorted and 3 windowed segment
   sums and 3 sorted gathers, and its captured variant under 4b's check.
   The kernels of this route are held against
   their plain versions in phase 3 too: ``ln_matmul`` at [16384, 384]
   bf16 with an f32 addend and without, and at [512, 384] f32, each
   bit-equal on a second launch; the LN
   backward at [512, 384] f32; ``sorted_gather_add`` with a [1056, 384]
   f32 table and an f32 addend (bit-equal); the segment sums on the
   bucketed layout, whose last window holds the padding, on bf16 rows
   (the edge->node sum) and on f32 rows (the cotangents of the deferred
   receivers term and of the senders gather); the windowed sum of f32
   [512, 384] rows into the 41 node slots of a sort-task batch; the
   sorted gather from a [1056, 384] bf16 table; the fused FFN at
   T = 1056;
C. run the single large graph (``benchmarks/bench_large_graph.py``: one
   graph of N = 65,536 nodes and E = 1,048,576 edges from seed 0, 3 GNCores
   at (256, 256, 256), bf16): one forward, which must launch the
   single-graph edge update (with its fused edge->node sum) 3 times and the
   fused FFN 6 times (edge and node sets; the 1-row graph set composes) and
   match the pure route within 5e-2 of each feature set's largest
   magnitude; then the train step (f32 masters, random bf16 targets,
   ``graph_loss_nf_ef``, AdamW(3e-4)) through ``make_train_step``, first
   with every core under ``remat`` (``GNCoreList(remat=True)``: its peak
   memory, each core's forward launched twice, loss within 1e-5 relative
   and gradients within 1e-2 of each tensor's largest magnitude of the
   step without remat), then without: per step
   3 single-graph edge updates, 6 FFN forwards and 6 FFN backwards, 3 LN
   backwards, 6 sorted segment sums (d tr, and the senders' sort-once
   scatter) and 3 sorted gathers (the agg cotangent).  Loss and gradients
   against the pure route's f32 twin (it and the bf16 twin are
   ``GNCoreList(remat=True)`` models, so that they fit): each gradient no
   further from the twin's, in the 2-norm, than 5e-2 of the twin's norm or
   1.5 times the pure bf16 route's own distance from it, and the loss
   likewise (its random-normal targets make it a sum with heavy
   cancellation).  Phase 4b's rule, which holds the two bf16 routes to each
   other by the largest element, fails at this size; its worst share and
   the largest-element distances are printed.  3 finite losses; eager time, a profile, the peak device
   memory; then one step with ``g1_agg_fusion_training`` off (the
   benchmark's ``--g1-agg 0``), which takes the kernel without the sum and
   9 sorted sums.  The kernels of this route are held against their plain
   versions in phase 3: the single-graph edge update with and without the
   sum at the large graph's shape (bf16 partials), at the sampled
   subgraph's shape (E = 56,320, N = 56,960, f32 partials, power-law
   receivers with a hub, empty nodes and pad edges on the last node) and on
   f32 rows, bit-equal on a second launch, and with a dead sender term of
   ef's type (``src_is_dead``) written over it with the same values; the FFN
   backward at T = 1,048,576 and 65,536 (d = 256) and at
   d = 128; the FFN forward, the LN backward, the sorted sum and the sorted
   gather at the shapes this route gives them; and the wide rows of
   ``ln_matmul`` and its backward (d = dout = 512 and 1024 in bf16, 640 in
   f32).  The rest of the fused FFN's gate: its forward at T = 16384 in
   bf16 at d = 512, its backward at T = 65,536 in bf16 at d = 384 and 512;
   on f32 rows (``F_FFN_FWD``, ``F_FFN_BWD``) the forward at phase F's
   shapes (T = 16384, 1024 and 8 at d = 384; 1,048,576 and 65,536 at
   d = 256) and the backward at T = 65,536 (d = 128, 256, 512) and
   1,048,576 (d = 256): forward 1e-5, dx 1e-4, the parameter gradients
   1e-2 of their largest magnitude.  The FFN backward and
   both segment sums also launch twice on the same inputs and must be
   bit-equal (a fixed summation order), as the FFN forward and the LN
   backward do at every shape.  Each segment-sum case prints the kernel
   the wrapper took (the one-pass kernel of ``small_plan`` for few rows,
   else the large-row one) beside ``index_add_``'s time and its bound; two
   more cases sit on each side of the one-pass kernel's crossover (16 and
   17 graphs of 16 nodes and 128 edges: 2048 and 2176 rows) and time the
   other path too.  The million-row cases are timed by
   5 eager calls between CUDA events, not by a CUDA graph;
F. run the JAX package's default precision (``Policy()`` computes in f32),
   with TF32 off for every f32 product: (a) the headline forward of phase
   4 with f32 parameters and features, no cast: per forward 9 fused FFN
   launches on f32 rows and, since the fused edge update's gate is bf16
   only, the split-linear edge route (3 ``ln_matmul``, 3
   ``sorted_gather_add``, 3 sorted sums), the route JAX's ``GNBlock``
   takes on the same batch (``tests/test_torch_f32_precision.py``);
   output within 1e-4 of each feature set's largest magnitude of the pure
   route; (b) C's graph with f32 features from the same numpy stream and
   C's stack in f32: the forward (3 single-graph edge updates with the
   sum, 6 FFN launches; 1e-4 of the pure route), then C's step through
   ``make_train_step(..., compute_dtype=None)`` (f32 targets, AdamW(3e-4)):
   C's launches a step (6 FFN forwards and backwards among them), loss
   within 1e-5 relative and each gradient within 1e-3 in the 2-norm of a
   pure-route f32 twin under ``remat``, or within twice the gap of a
   witness of the twin's own f32 order noise (the twin with each
   receiver's edges reordered), 3 finite losses, eager and
   captured times, a replay's kernels, the busy share and the peak
   memory;
D. run sampled training (``benchmarks/bench_arxiv.py``: a synthetic graph
   of 169,343 nodes and 1,166,243 edges with power-law in-degree, 128-d
   features, 40 classes; ``NeighborSampler((10, 10), batch 512)`` with
   node ids; ``EncodeProcessDecode((0, 128, 0) -> (256,) * 3 -> (1, 40,
   0))``, 2 cores, bf16 compute with f32 masters, Adam(1e-3)) through
   ``make_node_classification_step``: 1 + 10 steps on padded subgraphs of
   56,960 node slots and 56,320 edge slots.  The first loss must match the
   pure route's within 2e-2 relative and the first step's gradients the
   pure route's under phase 4b's rule, every loss be finite, and every step
   launch the single-graph edge update twice.  Print both routes' losses
   on the same batches, the step time with and without the host sampler
   (the native one, in line) and a profile.  The sorted sum ([56,320,
   256] bf16 into 56,960 segments), the sorted gather and ``sorted_gather_add`` are held against
   their plain versions in phase 3 at this route's shape: the first
   batch's receivers, ~51,670 of whose slots are pad edges on its pad
   node, with ~51,800 empty node slots behind it;
E. run sampled training as the JAX package runs it, at D's shape: the
   native sampler (its ms a batch beside the numpy path's), batches from a
   ``PrefetchPool`` of 2 workers (pinned CPU batches copied to the card on
   the workers' own streams) into the step captured as a CUDA graph; the
   captured step against the eager one under 4b's check, the pool's
   batches element for element against in-line native samplers with the
   same seeds, every loss finite; print the captured and the eager step,
   the pipeline's seeds/s beside phase D's in-line number and the busy
   share;
R. run ``random_gather`` through its entry point ([65,536, 256] bf16 table,
   1,048,576 random ids) against ``index_select``: bit-equal, one launch;
   print both times and rates;
P. run the parallel paths (``graphnets_tpu_torch.parallel``) at the
   headline's width (3 GNCores at (384,)*3, each data shard 4b's batch
   of 8 graphs in ``PadSpec.uniform(128, 2048)``, bf16 compute from f32
   masters, AdamW(3e-4)): (a) ``make_dp_train_step`` at world size 1 over
   NCCL through ``capture_step``, the all-reduce inside the graph, against
   4b's plain captured step on the same batch and weights (loss 1e-5
   relative, parameters 1e-5 of their largest + 0.1 lr), 4b's launches
   and one all-reduce a call, both captured times in turns; (b) two
   processes sharing the card over gloo (NCCL takes one rank a device;
   the collectives go through the host, which the log counts), at (data,
   model) = (2, 1) and (1, 2) (every weight the default ``min_size``
   shards): one step against one process over the same shards (loss
   1e-4 relative, parameters as in (a)), each rank's stored parameter and
   moment elements against the replicated count; (c) the pipeline, S = 2
   over the same two processes, 2 headline cores and M = 3 microbatches,
   the loss of every output squared: outputs and gradients within 1e-5
   of the largest magnitude of the sequential ``GNCoreList`` in this
   process on the same route, its launches the sum of the ranks', and
   the gradients against the plain route under 4b's rule (the inference
   edge update's backward on the card); (d) the flagship's warmup-cosine
   schedule: within 2 f32 ulps of optax's formula in numpy at steps 0,
   499, 500 and 19,999, 8 captured steps of the device loop writing the
   eager twin's rates bit for bit (parameters under (a)'s rule), and
   ``train_sort_device`` with it for one chunk.  The ranks report their
   launch counts to this process; the kernels line lists (a), the TP
   step and the pipeline as paths;
G. run edge-partitioned graph parallelism (``parallel/edge_partition``,
   ``edge_partition_stack``) on the graph of
   ``benchmarks/bench_partitioned.py --large`` (``build_single_graph``,
   seed 0: N = 65,536 nodes of in-degree 16, E = 1,048,576, C's stack of 3
   GNCores at (256,)*3 from C's seed, bf16 compute from f32 masters,
   ``partitioned_loss_nf_ef``, AdamW(3e-4)): (a) S = 1 over NCCL:
   ``gn_core_list_partitioned`` forward and the partitioned train step
   against the unpartitioned stack on the same graph and weights (each
   feature set within 5e-2 of its largest magnitude; the loss 1e-2
   relative), their launches against C's kernel stack (3 single-graph
   edge updates with the sum, 6 FFN forwards and backwards, 3 LN
   backwards, 6 sorted sums, 3 sorted gathers), eager and captured
   (``capture_step``, held to its eager twin by the captured-vs-eager
   rule) times of both and their ratio, peak memory, and no collective
   at one rank (JAX's collective over an axis of size 1 is the identity);
   (b) S = 2, two processes sharing the card over gloo: the forward's
   rows of each rank, mapped through ``edge_index``, against (a)'s (5e-2
   rule), one bf16 step's loss against an S = 1 step on the same routes
   (1e-4 relative; a shard's 32,768 node rows are under the fused FFN's
   training row gate, so that S = 1 step composes its node set too), one
   f32 step's loss (1e-4) and summed gradients (in the 2-norm, 1e-3 of
   each tensor's, as C's) against S = 1's, beside a witness of their f32
   noise ((a)'s f32 step with each node's edges reordered); both ranks'
   parameters bit-equal, and every element that breaks the
   captured-vs-eager rule against S = 1's has an S = 1 gradient within 4
   x the witness's largest gap in its tensor;
   each rank's launches, collectives (an all-to-all and a psum a core
   forward; the step 4 x 3 + 2) and host-staged calls, and the halo H;
   (c) the v1 / v2 / v3 blocks at S = 2 on a smaller graph at the
   headline width (N = 1024, in-degree 16 from within 32 ring places,
   ids scrambled; GNBlock (384,)*3, bf16) against each other and the
   unpartitioned GNBlock (5e-2 rule), v3 launching the single-graph edge
   update; (d) ``partition_edges_mincut`` and
   ``partition_edges_locality`` on that graph: fewer cut edges than
   contiguous blocks, and v2 on their layouts against the unpartitioned
   block (5e-2 rule); the v3 core on the min-cut layout's pad slots under
   training, the single-graph update with its sum and the composed route
   (``ln_matmul``, the sorted sum over ``Npad + 1`` segments), each
   against the plain route (5e-2 rule, real rows).  The kernels line lists G's paths;
5. print one JSON line listing the kernels (it fails if one was launched on
   no path), then the ``ok`` line.

``--phase flagship`` trains the flagship recipe (``benchmarks/run_flagship.py``,
f32): 20,000 steps of ``train_sort_device`` at a constant 3e-4 and with
the warmup-cosine schedule, each followed by ``evaluate_sort`` over 1024
batches, and prints ``graph_acc`` beside the JAX package's records, with
a curve of both accuracies every 2,000 steps; it exits 1 where one is
more than 0.05 below its record.

``--phase adamw`` holds the optimizer's update (``ops/kernels/adamw.py``)
on the sort model's 72 tensors and ``lg256``'s 90 (the benchmark's two
models) against torch's capturable foreach AdamW over 10 steps (4 f32
ulps of each tensor's largest magnitude), at the benchmark's rate and
decay (3e-4, 1e-4) and at 1e-2 and 0.1, where the decay alone moves each
value by 1e-3 of itself a step, then times one step of each as
CUDA-graph replays (kernel, torch's foreach AdamW as the plain version,
torch's fused AdamW as the yardstick the port never calls; in turns) with
its bound (28 bytes a value at 3.35 TB/s) and counts a step's kernels; it
exits 1 where the kernel disagrees.

``--phase split`` holds GraphCast's split first edge layer and its swish
(``ops/kernels/split_edge_layer.py``) at GraphCast_small's three shapes
(latent = hidden = 512; the 1 degree graph's ids for 4 samples: the
processor's 327,680 edge rows, g2m's 407,680, m2g's 781,952) against its
plain version (``pre`` and ``d_pre`` within one bf16 ulp, an ulp of
``pre`` no smaller than 2^-16 of the largest magnitude; ``h`` within one
ulp of swish of the kernel's own ``pre``; ``d_b`` within 1e-5 of each
column's sum of magnitudes of the f64 sums of the kernel's own ``d_pre``), then times the forward and the
backward (eager calls between CUDA events) beside their bound (bytes over
3.35 TB/s against bf16 FLOPs over 989 TFLOP/s; each node table counted
once), the plain version and the composed torch chain they replace
(forward: the edge product, the two gathers, the adds and swish; backward:
swish's backward and the bias gradient's column sum), and prints the
forward kernel's registers and spills; it exits 1 where the kernel
disagrees.

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
LARGE_ITERS = 5

# The single large graph (benchmarks/bench_large_graph.py) and the sampled
# arxiv-shaped training (benchmarks/bench_arxiv.py).
LG_N, LG_DEG, LG_D, LG_CORES = 65536, 16, 256, 3
LG_E = LG_N * LG_DEG
AX_N, AX_E, AX_FEAT, AX_CLASSES = 169_343, 1_166_243, 128, 40
AX_HIDDEN, AX_CORES, AX_FANOUTS, AX_BATCH = 256, 2, (10, 10), 512
AX_STEPS = 10
# The large-graph step's gradients (2-norm of a tensor) and loss may lie
# this many times as far from the f32 twin as the pure bf16 route's do.
G1_F32_SLACK = 1.5


def log(msg):
    print(msg, flush=True)


# The kernels whose ptxas report must show no spills: the wgmma / TMA
# kernels (the fused FFN forward and backward, the LN->matmul backward's
# passes and the core of the two fused edge updates and of ln_matmul's
# bf16 rows: edge_wgmma.cuh, every instance of the three; ln_matmul's are
# the instances with its LnMatmul policy) and the register-blocked f32
# kernels (F32_KERNELS) of the fused FFN pair, the LN->matmul backward and
# the single-graph edge update.
F32_KERNELS = ("ln_ffn_residual_f32_kernel", "ffn_bwd_hidden_f32_kernel",
               "ffn_bwd_gemm_f32_kernel", "ln_bwd_rows_f32_kernel",
               "ln_bwd_dxn_f32_kernel", "ln_bwd_pullback_f32_kernel",
               "ln_bwd_weights_f32_kernel", "g1_edge_update_f32_kernel")
F32_LIBRARIES = ("fused_ffn", "fused_ffn_bwd", "ln_linear_bwd",
                 "edge_update_g1")
TC_KERNELS = ("ln_ffn_residual_kernel", "ffn_bwd_gemm_kernel",
              "ln_bwd_rows_tc_kernel", "ln_bwd_dw_tc_kernel",
              "edge_update_tc_kernel") + F32_KERNELS
TC_POLICIES = ("Uniform", "Single", "LnMatmul")
# Matrix instructions of any type: none may appear in an f32 kernel, whose
# products are true-f32 multiply-adds (never TF32).
MMA_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA", "QGMMA", "BMMA", "DMMA")


def tensor_core_spills(logs):
    """Spill bytes (stored, loaded) of each instance of the tensor-core
    kernels in the compiler's ``-Xptxas -v`` report, by mangled name."""
    import re
    out, fn = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn and any(k in fn for k in TC_KERNELS):
                out[fn] = (int(m.group(1)), int(m.group(2)))
    return out


def f32_instructions(_build):
    """``cuobjdump -sass`` of the ``F32_LIBRARIES``: for each instance of
    the ``F32_KERNELS``, its count of FFMA instructions and the matrix
    instructions (``MMA_OPS``) it holds, which must be none."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in F32_LIBRARIES:
        sass = subprocess.run([tool, "-sass", str(_build._library(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            name = part.split("\n", 1)[0].strip()
            if any(k in name for k in F32_KERNELS):
                mma = re.findall(r"\b(" + "|".join(MMA_OPS) + r")\b", part)
                out[name] = {"FFMA": len(re.findall(r"\bFFMA\b", part)),
                             "mma": sorted(set(mma))}
    if (not all(any(k in n for n in out) for k in F32_KERNELS)
            or any(v["mma"] or not v["FFMA"] for v in out.values())):
        raise SystemExit(f"the f32 kernels must be FFMA kernels with no "
                         f"matrix instruction: {out}")
    return out


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


def grads_of(torch, model):
    """Each parameter's gradient, cloned; zeros where the loss does not
    reach it (the port's optimizer keeps no gradient there on the card
    and takes it as zero)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


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


def profile_replay(torch, replay):
    """The kernels of one replay of a captured step (``torch.profiler``
    records a CUDA graph's kernels): their count and summed device time,
    ``replay_busy_ms`` None where the profile shows no device time."""
    rows, busy, _ = profile_forward(torch, replay)
    return {"replay_busy_ms": busy or None,
            "replay_kernels": sum(r[1] for r in rows)}


def busy_share(busy_ms, wall_ms):
    """``busy_ms / wall_ms`` to three places, or "not measured"."""
    return "not measured" if busy_ms is None else f"{busy_ms / wall_ms:.3f}"


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
    h2, agg2 = eu.fused_edge_update_agg(*args)
    h_ref, _ = eu.fused_edge_update_agg_plain(
        ef, ln["scale"], ln["bias"], w0, ts, tr, tg, b, g.senders,
        g.receivers, g.slot_shape[1])
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(h, h2) and torch.equal(agg, agg2))
    own = torch.zeros_like(agg).index_add_(0, g.receivers, h.float())
    err_h = float((h.float() - h_ref.float()).abs().max())
    err_agg = float((agg - own).abs().max())
    # h: one bf16 ulp at the largest magnitude (the products accumulate in
    # another order, so a value near a rounding boundary may round the
    # other way); agg: f32 sums of the same rounded h in another order.
    tol_h = 2.0 ** -7 * float(h_ref.float().abs().max())
    tol_agg = 1e-5 * float(own.abs().max()) * max(1, E // N)
    ok = (err_h <= tol_h and err_agg <= tol_agg and bit_equal
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
            "agg_tol": tol_agg, "bit_equal": bit_equal, "ok": ok, **times,
            "bound_ms": bms, "bound_by": by}


def check_edge_update_wide(torch, eu, G, n_slots, e_slots, de, dout, seed):
    """The uniform update, with and without its sum, at widths the JAX
    gate admits beyond the headline's (de = 512 was refused before the
    port took that gate): random senders and sorted receivers in each
    graph's slots, the tail of each graph's edges padding on its last
    node.  The tolerances of ``check_edge_update``; both variants bit-equal
    on a second launch."""
    gen = torch.Generator().manual_seed(seed)
    E, N = G * e_slots, G * n_slots
    if not eu.supports_fused_edge_update(E, N, G, de, dout, n_slots, e_slots,
                                         torch.bfloat16, with_agg=True):
        raise SystemExit(f"the JAX gate refuses {G}x{n_slots}/{e_slots} "
                         f"{de}->{dout}")
    base = torch.arange(G).repeat_interleave(e_slots) * n_slots
    snd = torch.randint(0, n_slots, (E,), generator=gen) + base
    rcv = torch.sort(torch.randint(0, n_slots - 1, (G, e_slots),
                                   generator=gen), dim=1).values
    rcv[:, e_slots - e_slots // 8:] = n_slots - 1
    rcv = rcv.reshape(-1) + base
    snd, rcv = (t.to(torch.int32).cuda() for t in (snd, rcv))
    rnd = lambda *sh: torch.randn(*sh, generator=gen).cuda()
    ln = {"scale": 1 + 0.1 * rnd(de), "bias": 0.1 * rnd(de)}
    args = (rnd(E, de).to(torch.bfloat16), ln,
            (rnd(de, dout) * de ** -0.5).to(torch.bfloat16), rnd(N, dout),
            rnd(N, dout), rnd(G, dout), rnd(dout), snd, rcv, n_slots,
            e_slots)
    pargs = (args[0], ln["scale"], ln["bias"], *args[2:9], e_slots)
    with torch.no_grad():
        h, agg = eu.fused_edge_update_agg(*args)
        h2, agg2 = eu.fused_edge_update_agg(*args)
        h3, h4 = eu.fused_edge_update(*args), eu.fused_edge_update(*args)
        h_ref = eu.fused_edge_update_plain(*pargs)
        torch.cuda.synchronize()
        own = torch.zeros_like(agg).index_add_(0, rcv.long(), h.float())
        err_h = max(max_err(h, h_ref), max_err(h3, h_ref))
        err_agg = max_err(agg, own)
        tol_h = 2.0 ** -7 * float(h_ref.float().abs().max())
        tol_agg = 1e-5 * float(own.abs().max()) * max(1, E // N)
        bit_equal = bool(torch.equal(h, h2) and torch.equal(agg, agg2)
                         and torch.equal(h3, h4))
        ok = (err_h <= tol_h and err_agg <= tol_agg and bit_equal
              and bool(torch.isfinite(h.float()).all()))
        times = timed(torch, lambda: eu.fused_edge_update_agg(*args),
                      lambda: eu.fused_edge_update_agg_plain(*pargs))
        h_times = timed(torch, lambda: eu.fused_edge_update(*args),
                        lambda: eu.fused_edge_update_plain(*pargs))
    nbytes = (E * de * 2 + de * dout * 2 + 2 * N * dout * 4 + G * dout * 4
              + dout * 4 + 2 * de * 4 + 2 * E * 4 + E * dout * 2)
    bms, by = bound_ms(nbytes + N * dout * 4, 2 * E * de * dout)
    h_bms, _ = bound_ms(nbytes, 2 * E * de * dout)
    return {"shape": f"E={E} N={N} G={G} {de}->{dout} padded",
            "max_err": err_h, "tol": tol_h, "agg_max_err": err_agg,
            "agg_tol": tol_agg, "bit_equal": bit_equal, "ok": ok, **times,
            "bound_ms": bms, "bound_by": by,
            "h_kernel_ms": h_times["kernel_ms"],
            "h_plain_ms": h_times["plain_ms"], "h_bound_ms": h_bms}


def check_ffn(torch, ffn, T, seed, D=D, large=False, dtype=None):
    """Kernel 2 against its plain version at T rows of width D, bf16 (or
    ``dtype``) rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    dt = dtype or torch.bfloat16
    es = 2 if dt == torch.bfloat16 else 4
    x, extra = rnd(T, D).to(dt), rnd(T, D).to(dt)
    w = (1 + 0.1 * rnd(D), 0.1 * rnd(D),
         (rnd(D, 4 * D) * D ** -0.5).to(dt), (0.1 * rnd(4 * D)).to(dt),
         (rnd(4 * D, D) * (4 * D) ** -0.5).to(dt), (0.1 * rnd(D)).to(dt))
    with torch.no_grad():
        y = ffn.ln_ffn_residual(x, *w, extra=extra)
        ref = ffn.ln_ffn_residual_plain(x, *w, extra=extra)
        again = ffn.ln_ffn_residual(x, *w, extra=extra)
    torch.cuda.synchronize()
    equal = bool(torch.equal(y, again))  # split-K partials in a fixed order
    err = float((y.float() - ref.float()).abs().max())
    # bf16: two bf16 ulps at the largest magnitude (the final rounding,
    # plus a hidden value that rounds the other way after a differently
    # ordered f32 sum); f32: 1e-5 of it (f32 sums in another order).
    tol = (2.0 ** -6 if es == 2 else 1e-5) * float(ref.float().abs().max())
    kernel = lambda: ffn.ln_ffn_residual(x, *w, extra=extra)
    plain = lambda: ffn.ln_ffn_residual_plain(x, *w, extra=extra)
    with torch.no_grad():
        times = timed(torch, kernel, plain, large=large)
    nbytes = 3 * T * D * es + 2 * D * 4 * D * es + (2 * D + 4 * D + D) * 4
    flops = 4 * T * D * 4 * D
    bms, by = (bound_ms(nbytes, flops) if es == 2
               else bound_ms(nbytes, 0, flops_f32=flops))
    return {"shape": f"T={T} d={D}" + ("" if es == 2 else " f32"),
            "max_err": err, "tol": tol, "bit_equal_relaunch": equal,
            "ok": (err <= tol and equal
                   and bool(torch.isfinite(y.float()).all())),
            **times, "bound_ms": bms, "bound_by": by}


def timed(torch, kernel, plain, library=None, large=False):
    """Device times (CUDA-graph replay) and eager per-call times of a
    kernel and its plain version, and the device time of the one PyTorch
    call that computes the same function, where there is one.  ``large``
    (the million-row shapes, where a call takes a millisecond or more and
    the host's share vanishes): 5 back-to-back eager calls between CUDA
    events for every number, no graph capture, so that the plain versions'
    multi-gigabyte temporaries are not held in a capture's pool."""
    if large:
        ms = lambda fn: cuda_ms(torch, fn, iters=LARGE_ITERS, warmup=1)
        k, p = ms(kernel), ms(plain)
        return {"kernel_ms": k, "plain_ms": p, "kernel_call_ms": k,
                "plain_call_ms": p,
                "library_ms": None if library is None else ms(library)}
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
        h, h2, h_ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(h, h2))
        err = max_err(h, h_ref)
        tol = 2.0 ** -7 * float(h_ref.float().abs().max())
        times = timed(torch, kernel, plain)
    nbytes = (E * D * 2 + D * D * 2 + 2 * N * D * 4 + G * D * 4 + D * 4
              + 2 * D * 4 + 2 * E * 4 + E * D * 2)
    bms, by = bound_ms(nbytes, 2 * E * D * D)
    return {"shape": f"E={E} N={N} G={G} d={D} pad_aliases_real="
                     f"{g.pad_aliases_real}", "max_err": err, "tol": tol,
            "bit_equal": bit_equal,
            "ok": (err <= tol and bit_equal
                   and bool(torch.isfinite(h.float()).all())),
            **times, "bound_ms": bms, "bound_by": by}


def sum_path(torch, ss, name, E, N, D, dtype, G):
    """The kernel the wrapper takes for a sum: "one-pass" where
    ``small_plan`` gives a plan (few rows), else "large-row" (the chunked
    sorted kernel or the windowed tiles)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ss.small_plan(E, N, D, dtype, sms,
                         graphs=None if name == "sorted" else G)
    return ("one-pass" if plan else "large-row"), plan


def check_segment_sums(torch, ss, g, seed, dtype=None,
                       which=("sorted", "windowed"), D=D, large=False,
                       other=False):
    """The sorted (receivers) and windowed (senders) sums of an [E, D]
    input (bf16, or ``dtype``) into the N node segments of ``g``, against
    their plain versions: one bf16 ulp at the largest magnitude, or 1e-5
    of it for f32 rows (an f32 sum in another order).  The windows are the
    model's (``searchsorted`` of the graph ids), so on a bucketed batch
    the last one holds the padding.  ``library_ms``: ``index_add_`` of the
    f32 widening of x into a zeroed f32 buffer.  ``path``: the kernel the
    wrapper took (:func:`sum_path`); ``other`` (the crossover's cases):
    also the device time of the other path, launched directly
    (``other_path_ms``)."""
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
            out, ref, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        if getattr(ss, counts[name]) != before + 2:
            raise SystemExit(f"{name}_segment_sum did not launch its kernel")
        # A fixed summation order: a second launch is bit-equal.
        same = torch.equal(out, again)
        err = max_err(out, ref)
        tol = (2.0 ** -7 if es == 2 else 1e-5) * float(ref.float().abs().max())
        nbytes = E * D * es + E * 4 + N * D * es + (
            2 * (G + 1) * 4 if name == "windowed" else 0)
        bms, by = bound_ms(nbytes, 0, flops_f32=E * D)
        path, plan = sum_path(torch, ss, name, E, N, D, dtype, G)
        extra = {}
        if other:
            if plan is None:  # the one-pass kernel at the plan of 1 row
                plan = ss.small_plan(1, N, D, dtype, graphs=(
                    None if name == "sorted" else G))
                if name == "sorted":
                    fn = lambda: ss._launch_sorted_small(x, ids, N, plan)
                else:
                    fn = lambda: ss._launch_windowed_small(x, ids, N, *wins,
                                                           plan)
            elif name == "sorted":
                fn = lambda: ss._launch_sorted(x, ids, N)
            else:
                fn = lambda: ss._launch_windowed(x, ids, N, *wins)
            with torch.no_grad():
                alt = fn()
                torch.cuda.synchronize()
                extra = {"other_path_ms": graph_ms(torch, fn),
                         "other_path_max_err": max_err(alt, ref)}
        cases[name] = {"shape": f"{name} E={E} N={N} G={G} d={D} "
                                f"{'bf16' if es == 2 else 'f32'}",
                       "path": path,
                       "max_err": err, "tol": tol,
                       "bit_equal_relaunch": same,
                       "ok": (err <= tol and out.dtype == ref.dtype and same
                              and extra.get("other_path_max_err", 0) <= tol
                              and bool(torch.isfinite(out.float()).all())),
                       **timed(torch, kernel, plain, library, large),
                       "bound_ms": bms, "bound_by": by, **extra}
    return cases


def crossover_graph(torch, G, seed, npg=16, epg=128):
    """``G`` graphs of ``npg`` nodes and ``epg`` edges (by default the sort
    task's uniform slots) as the sums see them: receivers ascending,
    senders unsorted within their graph.  G = 16 gives 2048 rows, the
    one-pass kernel's largest; G = 17, 2176."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    snd = np.concatenate([rng.integers(0, npg, epg) + b * npg
                          for b in range(G)])
    rcv = np.sort(np.concatenate([rng.integers(0, npg, epg) + b * npg
                                  for b in range(G)]))
    t = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()
    receivers = t(rcv)
    return SimpleNamespace(
        device=receivers.device, num_edge_slots=G * epg,
        num_node_slots=G * npg, num_graph_slots=G, senders=t(snd),
        receivers=receivers, node_graph=t(np.repeat(np.arange(G), npg)),
        edge_graph=t(np.repeat(np.arange(G), epg)))


def sum_cases(torch, ss, g):
    """Phase 3's segment sums by name, on the layouts ``g`` (a dict:
    exact, bucket, sort, sort_u, large, samp, and the crossover's two)."""
    f32 = torch.float32
    return {
        "exact": check_segment_sums(torch, ss, g["exact"], 30),
        "bucket": check_segment_sums(torch, ss, g["bucket"], 33),
        # f32 rows: the cotangents that the bucketed step's deferred
        # receivers term and senders gather scatter back, and the sort
        # task's.
        "bucket32": check_segment_sums(torch, ss, g["bucket"], 39, f32),
        "sort32": check_segment_sums(torch, ss, g["sort"], 40, f32,
                                     which=("windowed",)),
        "large": check_segment_sums(torch, ss, g["large"], 60,
                                    which=("sorted",), D=LG_D, large=True),
        # The sampled route's (D): the first batch's receivers, ~51,670 of
        # whose 56,320 slots are pad edges on the pad node.
        "samp": check_segment_sums(torch, ss, g["samp"], 80,
                                   which=("sorted",), D=LG_D),
        "sort_u": check_segment_sums(torch, ss, g["sort_u"], 86),
        "sort_u32": check_segment_sums(torch, ss, g["sort_u"], 87, f32),
        # Each side of the one-pass kernel's crossover, with the time of
        # the other path.
        "cross_small": check_segment_sums(torch, ss, g["cross_small"], 89,
                                          other=True),
        "cross_large": check_segment_sums(torch, ss, g["cross_large"], 90,
                                          other=True),
    }


def log_sums(seg, where):
    """One line a segment-sum case: the path it took, its time beside
    ``index_add_``'s and its bound."""
    for cases in seg.values():
        for c in cases.values():
            other = (f", other path {c['other_path_ms']:.4f} ms"
                     if "other_path_ms" in c else "")
            lib = c["library_ms"]
            log(f"segment sum {c['shape']}: {c['path']} {c['kernel_ms']:.4f} "
                f"ms, index_add_ {lib:.4f} ms ({c['kernel_ms'] / lib:.2f}x), "
                f"bound {c['bound_ms']:.4f} ms ({c['bound_ms'] / c['kernel_ms']:.3f} "
                f"of it), plain {c['plain_ms']:.4f} ms{other}; ok {c['ok']}; "
                f"{where}")


def check_gather(torch, ga, g, seed, D=D, large=False):
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
    # The table rows this run's ids need (a sampled batch's pad edges all
    # read one row), each read once.
    rows = int(torch.unique(g.receivers).numel())
    bms, by = bound_ms(rows * D * 2 + E * 4 + E * D * 2, 0)
    return {"shape": f"table [{N}, {D}] bf16 -> {E} rows",
            "max_err": max_err(out, ref), "tol": 0.0,
            "ok": bool(torch.equal(out, ref)),
            **timed(torch, kernel, plain,
                    lambda: table.index_select(0, idx_long), large),
            "bound_ms": bms, "bound_by": by}


def check_ln_backward(torch, ll, lnp, T, seed, dtype=None, D=D, large=False,
                      two_step=False):
    """The LN->matmul backward at T rows, d = dout = D.  bf16 rows: dx
    within 2^-6 and dW, dscale, dbias within 1e-3 of their largest
    magnitudes; f32 rows: all within 1e-4 (f32 sums in another order).
    ``two_step`` sends bf16 rows of a width that the one-kernel row pass
    serves through the two-step row pass instead (the form of every other
    width), to hold it and time it beside the other."""
    if two_step:
        one_step, ll._one_step_rows = ll._one_step_rows, lambda *a: False
        try:
            case = check_ln_backward(torch, ll, lnp, T, seed, dtype, D, large)
        finally:
            ll._one_step_rows = one_step
        case["shape"] += " row pass in two steps"
        return case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = dtype or torch.bfloat16
    es = 2 if bf == torch.bfloat16 else 4
    args = (rnd(T, D).to(bf), 1 + 0.1 * rnd(D), 0.1 * rnd(D),
            (rnd(D, D) * D ** -0.5).to(bf), rnd(T, D).to(bf))
    kernel = lambda: ll.ln_linear_backward(*args)
    plain = lambda: lnp.ln_linear_backward_plain(*args)
    out, ref, again = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    # A fixed summation order: a second launch is bit-equal.
    equal = all(torch.equal(o, a) for o, a in zip(out, again))
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
    case = {"shape": f"T={T} d={D} dout={D} {'bf16' if es == 2 else 'f32'}",
            "max_err": max(max_err(o, r) for o, r in zip(out, ref)),
            "rel_err": rel, "tol": tols, "bit_equal_relaunch": equal,
            "ok": finite and equal and all(rel[n] <= tols[n] for n in names),
            **timed(torch, kernel, plain, large=large), "bound_ms": bms,
            "bound_by": by}
    if ll._one_step_rows(D, D, bf):
        # The tensor-core passes alone: the row pass, the dW pass without
        # and with its fused reduction (differences of three timings).
        t = {p: (cuda_ms(torch, lambda p=p: ll._launch(*args, passes=p),
                         iters=LARGE_ITERS, warmup=1) if large
                 else graph_ms(torch, lambda p=p: ll._launch(*args,
                                                             passes=p)))
             for p in (1, 3, 7)}
        case["pass_ms"] = {"rows": t[1], "dw": t[3] - t[1],
                           "reduction": t[7] - t[3]}
    return case


def check_ln_matmul(torch, ll, lnp, T, seed, dtype, addend_dtype, D=D):
    """``ln_matmul`` at T rows, d = dout = D, against its plain version,
    and bit-equal on a second launch.  The first three rows have var == 0.
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
        out, ref, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        if ll.FWD_LAUNCHES != before + 2:
            raise SystemExit("ln_matmul did not launch its kernel")
        equal = torch.equal(out, again)
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
            "bit_equal_relaunch": equal,
            "ok": (err <= tol and out.dtype == ref.dtype and equal
                   and bool(torch.isfinite(out.float()).all())),
            **times, "bound_ms": bms, "bound_by": by}


def check_gather_add(torch, ga, g, seed, D=D):
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
    rows = int(torch.unique(g.receivers).numel())
    bms, by = bound_ms(rows * D * 4 + E * 4 + 2 * E * D * 4, 0,
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


def forward_phase(torch, pt, g, expect, zero_counts, read_counts, what,
                  dtype=None, tol=5e-2):
    """One forward of 3 GNCores at (D, D, D) with seeded params of
    ``dtype`` (bf16 by default) on ``g`` (features of that type), counters
    set to 0 just before and read just after; the output against the pure
    route (kernels off) on the card, within ``tol`` of each feature set's
    largest magnitude; eager and CUDA-graph times of both routes and a
    profile of one eager forward.  Raises ``SystemExit`` on a wrong launch
    count or a wrong output."""
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((D, D, D), generator=gen)
                           for _ in range(N_CORES)]).to(
                               dtype or torch.bfloat16)
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
    # test_gncore_fused_matches_pure holds the f32 routes to rtol 1e-4
    # (phase F's ``tol``); in bf16 (8-bit mantissa) three cores of
    # differently rounded residual sums are held to 5e-2 of the largest
    # magnitude of each feature set.
    path_err = {}
    for key in ("ef", "nf", "gf"):
        a, r = np.asarray(out[key], np.float32), np.asarray(ref[key],
                                                            np.float32)
        if a.shape != r.shape or not np.isfinite(a).all():
            raise SystemExit(f"{what} {key}: bad shape or non-finite")
        path_err[key] = float(np.abs(a - r).max() / np.abs(r).max())
    log(f"{what} vs pure route (max err / max |ref|): {path_err}, "
        f"tolerance {tol}")
    if max(path_err.values()) > tol:
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
    grads = grads_of(torch, model)
    pt.enable_kernels(False)
    mp = pure_step(g, y)
    f32 = lambda t: t.float()
    f32_step(g.with_features(ef=f32(g.ef), nf=f32(g.nf), gf=f32(g.gf)),
             y.with_features(ef=f32(y.ef), nf=f32(y.nf)))
    torch.cuda.synchronize()
    pt.enable_kernels(True)
    loss, pure_loss = float(m["loss"]), float(mp["loss"])
    pure, grads32 = grads_of(torch, twin), grads_of(torch, twin32)
    ratios = {}
    for n, t in pure.items():
        bound = max(5e-2 * float(t.abs().max()),
                    float((t - grads32[n]).abs().max()))
        err = float((grads[n] - t).abs().max())
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

    def build():
        gen = torch.Generator().manual_seed(0)
        m = pt.GNCoreList([pt.GNCore((D, D, D), generator=gen)
                           for _ in range(N_CORES)])
        return m, pt.make_train_step(m, pt.adamw(m.parameters(), 3e-4),
                                     compute_dtype=torch.bfloat16)

    captured = captured_check(torch, pt, build, (g, y), 3e-4, expect,
                              zero_counts, read_counts, what)
    return {"launches": launches, "captured": captured,
            "loss": loss, "pure_loss": pure_loss,
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
    cap = train["captured"]
    log(f"{what} captured as a CUDA graph: {cap['captured_ms']:.4f} ms a "
        f"step ({n_edges / cap['captured_ms'] * 1e3:.4e} edges/s) against "
        f"{cap['eager_ms']:.4f} ms eager, kernel route; one profiled replay "
        f"{cap['replay_kernels']} kernels of "
        f"{cap['replay_busy_ms'] or 0:.4f} ms, busy share "
        f"{busy_share(cap['replay_busy_ms'], cap['captured_ms'])} (kernel "
        f"time of a replay / captured time); {where}")


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
        f"step alone: {first_launches}); the step was captured "
        f"{res.step.captures} time(s) and replayed {res.step.replays} times")
    # Per step: the two cores' ln_matmul and LN backward, and the windowed
    # sum behind the senders gather of the encoder and of each core (512
    # rows of width 384 pass its gate; the decoder's width 2 does not).
    # train_sort captures its step: the counters count the calls that pass
    # through the wrappers (the warm-ups and the capture); the replays
    # launch the captured kernels without them.
    one = dict(ln_matmul=2, ln_backward=2, windowed=3)
    want = lambda calls: {k: one.get(k, 0) * calls for k in launches}
    if (launches != want(res.step.traced_calls)
            or first_launches != want(first.step.traced_calls)
            or res.step.captures != 1 or res.step.replays != SORT_STEPS):
        raise SystemExit(f"train_sort did not launch ln_matmul and the LN "
                         f"backward twice a step, the windowed sum 3 times "
                         f"and nothing else, or did not replay one captured "
                         f"step: {launches}, first step {first_launches}")
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
    captured = pt.capture_step(step)
    captured_ms = cuda_ms(torch, lambda: captured(x, y), iters=10)
    replay = profile_replay(torch, lambda: captured(x, y))
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: res.model(x), iters=10)
        fwd_graph_ms = graph_ms(torch, lambda: res.model(x), iters=10)
    return {"launches": launches, "first_launches": first_launches,
            "captured_step_ms": captured_ms,
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
            "fwd_ms": fwd_ms, "fwd_graph_ms": fwd_graph_ms, **replay}


# Phase S: the sort flagship as the JAX package runs it by default.
S_CHUNK, S_CHUNKS = 200, 3       # train_sort_device: 3 chunks of 200 steps
S_CHECK_STEPS = 4                # the captured chunk held to the eager one
S_BF16_CHUNK = 100
S_EVAL_BATCHES = 16
# What one eager step of the device loop launches (phase A's f32 step),
# and its bf16 variants: the non-uniform layout takes the same kernels in
# bf16; the uniform one (16 node / 128 edge slots a graph, which pass the
# JAX gate's _pick_k) takes the fused edge update without its sum under
# training, and the sorted sums of its backward.
S_PER_STEP = {
    "f32": dict(ln_matmul=2, ln_backward=2, windowed=3),
    "bf16": dict(ln_matmul=2, ln_backward=2, windowed=3),
    "bf16 uniform": dict(edge=2, gather_add=1, ln_backward=2, windowed=3,
                         segment_sum=3),
}


def check_sort_batch(pt, x, y, cfg):
    """Phase S (a): a device batch passes ``validate_graph`` and the
    host-generator semantics of ``tests/test_device_data.py``: one-hot
    inputs, "is minimum" node targets, the full graph in canonical
    column-major order, the host generator's edge targets, clean padding.
    Raises ``SystemExit`` on a miss."""
    from graphnets_tpu_torch.data.sort_task import _edge_targets

    def need(ok, what):
        if not ok:
            raise SystemExit(f"device batch: {what}")

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    for g in (x, y):
        pt.validate_graph(g)
    B = cfg.batch_size
    n_node, n_edge = host(x.n_node), host(x.n_edge)
    need(((n_node[:B] >= cfg.min_nodes) & (n_node[:B] <= cfg.max_nodes)
          ).all() and (n_edge[:B] == n_node[:B] ** 2).all(), "sizes")
    nf, ynf, yef = host(x.nf), host(y.nf), host(y.ef)
    s, r = host(x.senders), host(x.receivers)
    nm, em = host(x.node_mask), host(x.edge_mask)
    if x.slot_shape is None:
        noff = np.concatenate([[0], np.cumsum(n_node[:B])])
        eoff = np.concatenate([[0], np.cumsum(n_edge[:B])])
    else:
        noff = np.arange(B + 1) * x.slot_shape[0]
        eoff = np.arange(B + 1) * x.slot_shape[1]
    for b in range(B):
        n = int(n_node[b])
        rows = slice(noff[b], noff[b] + n)
        vals = nf[rows].argmax(-1) + 1
        need((nf[rows].sum(-1) == 1).all(), "one-hot inputs")
        need((ynf[rows].argmax(-1) == (vals == vals.min())).all(),
             "is-minimum targets")
        edges, k = slice(eoff[b], eoff[b] + n * n), np.arange(n * n)
        need((r[edges] - noff[b] == k // n).all()
             and (s[edges] - noff[b] == k % n).all(), "canonical order")
        need((yef[edges].argmax(-1) == _edge_targets(vals)).all(),
             "edge targets")
    need((nf[~nm] == 0).all() and (np.diff(r) >= 0).all(), "padding")
    if x.slot_shape is None:
        N = int(nm.sum())
        need((s[~em] == N).all() and (r[~em] == N).all(), "pad edges")


def device_sort_phase(torch, pt, zero_counts, read_counts):
    """Phase S: ``train_sort_device`` (batches generated on the card inside
    the captured step) at full width, with checks (a)-(i) of the script's
    docstring.  Raises ``SystemExit`` on any miss."""
    import importlib.util
    import os
    import tempfile
    dev, lr = torch.device("cuda"), 3e-4
    cfg = pt.SortTaskConfig()
    kw = dict(cfg=cfg, core_dims=(D, D, D), n_cores=2, learning_rate=lr,
              chunk=S_CHUNK)
    out = {}

    # (a) Device batches on the card.
    gen = torch.Generator(device=dev).manual_seed(0)
    for uniform, count in ((False, 8), (True, 2)):
        pad = pt.sort_pad_spec(cfg, uniform)
        for _ in range(count):
            check_sort_batch(pt, *pt.device_batch(gen, cfg, pad), cfg)
    log("device batches: 8 sort_pad_spec and 2 uniform batches pass "
        "validate_graph and the host generator's semantics")

    def state(seed):
        model = pt.EncodeProcessDecode(
            (0, cfg.vocab_size, 0), (D, D, D), (2, 2, 0), n_cores=2,
            device=dev, generator=torch.Generator().manual_seed(seed))
        return pt.TrainState(model, pt.adamw(model.parameters(), lr), 0,
                             (torch.Generator(device=dev).manual_seed(seed),))

    # (b) + (c) One eager step on each route from the same state and
    # generator state (so the same batch), the kernel route counted.
    sk, sp = state(1), state(1)
    step_k = pt.make_sort_device_step(sk, cfg)
    step_p = pt.make_sort_device_step(sp, cfg)
    zero_counts()
    step_k()
    torch.cuda.synchronize()
    launches = read_counts()
    pt.enable_kernels(False)
    step_p()
    pt.enable_kernels(True)
    loss, plain_loss = float(step_k.sums["loss"]), float(step_p.sums["loss"])
    worst = (0.0, "")
    for (n, p), q in zip(sk.model.named_parameters(),
                         sp.model.parameters()):
        if p.numel():
            rel = float((p.grad - q.grad).abs().max()) / max(
                float(q.grad.abs().max()), 1e-30)
            worst = max(worst, (rel, n))
    log(f"device sort step vs plain route: loss {loss:.7f} vs "
        f"{plain_loss:.7f} (tolerance 1e-4 relative); worst gradient "
        f"{worst[1]} off by {worst[0]:.3e} of its largest magnitude "
        f"(tolerance 1e-3); launches {launches}")
    if (not np.isfinite(loss) or worst[0] > 1e-3
            or abs(loss - plain_loss) > 1e-4 * abs(plain_loss)):
        raise SystemExit("the device sort step disagrees with the plain "
                         "route")
    want_counts(launches, S_PER_STEP["f32"], "the f32 device sort step")
    out.update(step_launches=launches, loss=loss, plain_loss=plain_loss,
               worst_grad=worst)
    # The bf16 variants: the same check under phase 4b's bf16 rule (loss
    # 1e-2 relative; each gradient within 5e-2 of its largest magnitude or
    # the pure route's bf16-vs-f32 distance, from an f32 twin on the same
    # batch), so each variant's kernels are held at its own shapes.
    variants, bf16_checks = {}, {}
    for name, uniform in (("bf16", False), ("bf16 uniform", True)):
        pad = pt.sort_pad_spec(cfg, uniform)
        sk, sp, s32 = state(1), state(1), state(1)
        step_k = pt.make_sort_device_step(sk, cfg, pad, torch.bfloat16)
        step_p = pt.make_sort_device_step(sp, cfg, pad, torch.bfloat16)
        step_32 = pt.make_sort_device_step(s32, cfg, pad)
        zero_counts()
        step_k()
        torch.cuda.synchronize()
        variants[name] = read_counts()
        pt.enable_kernels(False)
        step_p()
        step_32()
        pt.enable_kernels(True)
        loss_b, pure_b, f32_b = (float(x.sums["loss"])
                                 for x in (step_k, step_p, step_32))
        grads32 = dict(s32.model.named_parameters())
        worst_b = (0.0, "")
        for (n, p), q in zip(sk.model.named_parameters(),
                             sp.model.parameters()):
            if p.numel():
                bound = max(5e-2 * float(q.grad.abs().max()),
                            float((q.grad - grads32[n].grad).abs().max()))
                err = float((p.grad - q.grad).abs().max())
                worst_b = max(worst_b, (err / bound if bound > 0
                                        else float(err > 0), n))
        log(f"{name} device sort step vs plain route: loss {loss_b:.6f} vs "
            f"{pure_b:.6f} (f32 twin {f32_b:.6f}; tolerance 1e-2 relative); "
            f"worst gradient {worst_b[1]} at {worst_b[0]:.4f} of its bound "
            f"(max of 5e-2 x its largest magnitude and the pure route's "
            f"bf16-vs-f32 distance); launches {variants[name]}")
        if (not np.isfinite(loss_b) or worst_b[0] > 1.0
                or abs(loss_b - pure_b) > 1e-2 * abs(pure_b)):
            raise SystemExit(f"the {name} device sort step disagrees with "
                             f"the plain route")
        want_counts(variants[name], S_PER_STEP[name],
                    f"the {name} device sort step")
        bf16_checks[name] = dict(loss=loss_b, plain_loss=pure_b,
                                 f32_loss=f32_b, worst_grad=worst_b)
    out.update(bf16_launches=variants, bf16_checks=bf16_checks)

    # (d) A captured chunk against the eager chunk from the same state and
    # generator state.
    (sc, se) = state(2), state(2)
    step_c = pt.make_sort_device_step(sc, cfg)
    step_e = pt.make_sort_device_step(se, cfg)
    cap = pt.capture_step(step_c)
    zero_counts()
    for _ in range(S_CHECK_STEPS):
        cap()
    torch.cuda.synchronize()
    cap_launches = read_counts()
    want_counts(cap_launches, {k: v * cap.traced_calls for k, v in
                               S_PER_STEP["f32"].items()},
                "the captured device sort step")
    for _ in range(S_CHECK_STEPS):
        step_e()
    loss_c, loss_e = (float(x.sums["loss"]) / S_CHECK_STEPS
                      for x in (step_c, step_e))
    rel = abs(loss_c - loss_e) / abs(loss_e)
    worst_p = (0.0, "")
    for (n, p), q in zip(sc.model.named_parameters(), se.model.parameters()):
        if p.numel():
            p, q = p.detach(), q.detach()
            bound = 1e-5 * float(q.abs().max()) + 0.1 * lr
            worst_p = max(worst_p, (float((p - q).abs().max()) / bound, n))
    log(f"captured device chunk of {S_CHECK_STEPS} steps vs eager: mean "
        f"loss {loss_c:.7f} vs {loss_e:.7f} ({rel:.3e} relative, tolerance "
        f"1e-5); worst parameter {worst_p[1]} at {worst_p[0]:.4f} of its "
        f"bound (1e-5 x its largest magnitude + 0.1 x lr); {cap.captures} "
        f"capture, {cap.replays} replays, launches {cap_launches}")
    if not np.isfinite(loss_c) or rel > 1e-5 or worst_p[0] > 1.0:
        raise SystemExit("the captured device chunk disagrees with the "
                         "eager one")
    out.update(chunk_check=dict(loss=loss_c, eager_loss=loss_e,
                                loss_rel=rel, worst_param=worst_p))
    out["eager_step_ms"] = cuda_ms(torch, step_e, iters=5)
    out["captured_step_ms"] = cuda_ms(torch, cap, iters=20)
    prof_rows, busy_ms, wall_ms = profile_forward(torch, step_e)
    out.update(busy_ms=busy_ms, prof_rows=prof_rows,
               kernels_per_step=sum(r[1] for r in prof_rows),
               **profile_replay(torch, cap))

    # (e) Replays of a captured batch draw fresh batches, the sequence
    # eager calls draw from the same generator state.
    bgen = torch.Generator(device=dev).manual_seed(3)

    def batch_step():
        x, y = pt.device_batch(bgen, cfg)
        return x.nf, x.senders, x.n_node, y.ef

    batch_step.generators = (bgen,)
    bcap = pt.capture_step(batch_step)
    start = bgen.get_state()
    replays = [bcap() for _ in range(3)]
    bgen.set_state(start)
    eager = [batch_step() for _ in range(3)]
    same = all(torch.equal(a, b) for ra, ea in zip(replays, eager)
               for a, b in zip(ra, ea))
    fresh = not torch.equal(replays[0][0], replays[1][0])
    log(f"captured batch replays: equal to eager draws {same}, two replays "
        f"differ {fresh}")
    if not (same and fresh):
        raise SystemExit("captured device batches do not follow their "
                         "generator")

    # The main path: 3 chunks of 200 steps, counters read around it.
    zero_counts()
    full = pt.train_sort_device(steps=S_CHUNKS * S_CHUNK, seed=0,
                                log_fn=lambda st, m: log(
                                    f"  step {st}: " + ", ".join(
                                        f"{k}={v:.4f}"
                                        for k, v in m.items())), **kw)
    torch.cuda.synchronize()
    train_launches = read_counts()
    want_counts(train_launches, {k: v * full.step.traced_calls for k, v in
                                 S_PER_STEP["f32"].items()},
                "train_sort_device")
    if (full.step.captures != 1
            or full.step.replays != S_CHUNKS * S_CHUNK
            or not all(np.isfinite(v) for v in full.metrics.values())):
        raise SystemExit(f"train_sort_device: {full.step.captures} "
                         f"captures, {full.step.replays} replays, metrics "
                         f"{full.metrics}")
    out.update(train_launches=train_launches, metrics=full.metrics,
               steps_per_sec=full.steps_per_sec)

    # (f) A checkpoint at a chunk boundary, restored into a fresh model and
    # optimizer, then the last chunk: bit-equal to the run straight through.
    with tempfile.TemporaryDirectory() as tmp:
        half = pt.train_sort_device(steps=(S_CHUNKS - 1) * S_CHUNK, seed=0,
                                    **kw)
        mgr = pt.CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(half.state.step, half.state)
        resumed = mgr.restore(state(99))
        rest = pt.train_sort_device(steps=S_CHUNK, state=resumed, **kw)
        differ = [n for (n, p), q in zip(full.model.named_parameters(),
                                         rest.model.parameters())
                  if not torch.equal(p, q)]
        log(f"resumed at step {half.state.step} from a checkpoint: "
            f"{len(differ)} parameter tensors differ from the run straight "
            f"through; metrics {rest.metrics} vs {full.metrics}")
        if differ or rest.metrics != full.metrics or rest.state.step != \
                full.state.step:
            raise SystemExit(f"the resumed run is not bit-equal: {differ}")

        # (i) The example's SVGs.
        spec = importlib.util.spec_from_file_location(
            "sort_torch_example", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "examples",
                "sort_torch.py"))
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        svg_dir = os.path.join(tmp, "svg")
        example.show_sample(full.model, cfg, svg_dir=svg_dir)
        svgs = {name: open(os.path.join(svg_dir, name)).read()
                for name in sorted(os.listdir(svg_dir))}
        if sorted(svgs) != ["input.svg", "pred.svg", "target.svg"] or not \
                all(t.startswith("<svg") and t.endswith("</svg>")
                    for t in svgs.values()):
            raise SystemExit(f"the SVGs were not written: {sorted(svgs)}")
        log(f"SVGs written: {', '.join(f'{n} ({len(t)} bytes)' for n, t in svgs.items())}")

    # (g) evaluate_sort on both routes: the same batches (one generator
    # seed), within one slot a batch: a flip of one node, one edge or one
    # graph in each batch of the smallest graphs the task draws.
    zero_counts()
    acc = pt.evaluate_sort(full.model, cfg, n_batches=S_EVAL_BATCHES)
    torch.cuda.synchronize()
    eval_launches = read_counts()
    pt.enable_kernels(False)
    plain_acc = pt.evaluate_sort(full.model, cfg, n_batches=S_EVAL_BATCHES)
    pt.enable_kernels(True)
    B, m = cfg.batch_size, cfg.min_nodes
    slack = dict(node_acc=1 / (B * m), edge_acc=1 / (B * m * m),
                 graph_acc=1 / B)
    log(f"evaluate_sort after {S_CHUNKS * S_CHUNK} steps ({S_EVAL_BATCHES} "
        f"device batches, captured): {acc}; plain route {plain_acc} "
        f"(within {slack}); launches {eval_launches}")
    # Its forward is captured: two warm-ups and the capture pass through
    # the wrappers, two ln_matmul each.
    want_counts(eval_launches,
                {"ln_matmul": 2 * (pt.CapturedStep.WARMUP_CALLS + 1)},
                "evaluate_sort")
    if any(abs(acc[k] - plain_acc[k]) > slack[k] for k in acc):
        raise SystemExit("evaluate_sort differs between the routes")
    out.update(acc=acc, plain_acc=plain_acc, eval_launches=eval_launches)

    # (h) One chunk in bf16, in both layouts.
    out["bf16_metrics"] = {}
    for name, uniform in (("bf16", False), ("bf16 uniform", True)):
        res = pt.train_sort_device(
            steps=S_BF16_CHUNK, cfg=cfg, core_dims=(D, D, D), n_cores=2,
            learning_rate=lr, chunk=S_BF16_CHUNK, seed=0,
            dtype=torch.bfloat16, uniform=uniform)
        log(f"{name} chunk of {S_BF16_CHUNK} steps: {res.metrics}")
        if not all(np.isfinite(v) for v in res.metrics.values()):
            raise SystemExit(f"non-finite {name} metrics: {res.metrics}")
        out["bf16_metrics"][name] = res.metrics
    return out


def sorted_receivers(torch, E, N, kind, gen, device):
    """Ascending receiver ids for a kernel check.  ``uniform``: E draws from
    [0, N).  ``power``: a sampled subgraph's shape: two fifths of the slots
    hold real edges with power-law receivers (p ~ 1 / (rank + 10)) over the
    first N - 1 nodes, one of them a hub with a tenth of the slots (it spans
    many 64-row tiles), many nodes have no edge, and the remaining slots are
    pad edges on the last node."""
    if kind == "uniform":
        r = torch.randint(0, N, (E,), generator=gen)
    else:
        real = E * 2 // 5
        p = 1.0 / (torch.arange(N - 1, dtype=torch.float32) + 10.0)
        r = torch.multinomial(p, real, replacement=True, generator=gen)
        r[: E // 10] = 7
        r = torch.cat([r, torch.full((E - real,), N - 1)])
    return torch.sort(r).values.to(torch.int32).to(device)


def check_g1(torch, g1, E, N, d, dtype, part_dtype, kind, seed, large=False):
    """The single-graph edge update, with and without the edge->node sum,
    against its plain version.  bf16 rows: h within one bf16 ulp at the
    largest magnitude; f32 rows: within 1e-5 of it (f32 sums in another
    order); agg: within 1e-5 x the mean in-degree of the f32 sum of the
    kernel's own rounded h.  No single PyTorch call computes LN, product,
    gather and adds, so ``library_ms`` is null."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    ef = rnd(E, d)
    ef[:3] = 0.0  # var == 0 rows
    ef = ef.to(dtype)
    ln = {"scale": 1 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    w0 = (rnd(d, d) * d ** -0.5).to(dtype)
    src, tr, gb = rnd(E, d).to(part_dtype), rnd(N, d).to(part_dtype), rnd(d)
    rl = sorted_receivers(torch, E, N, kind, gen, "cuda")
    args = (ef, ln, w0, src, tr, rl, gb)
    pargs = (ef, ln["scale"], ln["bias"], w0, src, tr, rl, gb)
    es, ps = ef.element_size(), src.element_size()
    name = lambda t: str(t).replace("torch.", "")
    shape = (f"E={E} N={N} d={d} {name(dtype)} partials {name(part_dtype)} "
             f"{kind} receivers")
    cases = []
    with torch.no_grad():
        before = (g1.LAUNCHES, g1.LAUNCHES_NO_AGG)
        kept = src.clone()
        h, agg = g1.fused_g1_edge_update_agg(*args)
        h2 = g1.fused_g1_edge_update(*args)
        h_again, agg_again = g1.fused_g1_edge_update_agg(*args)
        h2_again = g1.fused_g1_edge_update(*args)
        h_ref = g1.g1_edge_update_plain(*pargs)
        # h written over a dead sender term of ef's type, as GNBlock hands
        # it over: the same values, in src's storage.
        dead = src.clone()
        h_dead, agg_dead = g1.fused_g1_edge_update_agg(
            ef, ln, w0, dead, tr, rl, gb, src_is_dead=True)
        torch.cuda.synchronize()
        if (g1.LAUNCHES, g1.LAUNCHES_NO_AGG) != (before[0] + 3,
                                                  before[1] + 2):
            raise SystemExit(f"fused_g1_edge_update did not launch: {shape}")
        bit_equal = bool(torch.equal(h, h_again) and torch.equal(agg, agg_again)
                         and torch.equal(h2, h2_again))
        aliased = h_dead.data_ptr() == dead.data_ptr()
        alias_ok = (aliased == (part_dtype == dtype)
                    and torch.equal(h_dead, h) and torch.equal(agg_dead, agg)
                    and torch.equal(src, kept))
        del h_again, agg_again, h2_again, h_dead, agg_dead, dead, kept
        own = torch.zeros_like(agg).index_add_(0, rl.long(), h.float())
        err_agg = max_err(agg, own)
        tol_agg = 1e-5 * float(own.abs().max()) * max(1, E // N)
        tol = (2.0 ** -7 if es == 2 else 1e-5) * float(h_ref.float().abs().max())
        # Each input read once: of tr only the rows that some edge names.
        tr_rows = int(torch.unique(rl[(rl >= 0) & (rl < N)]).numel())
        nbytes = (2 * E * d * es + d * d * es + E * d * ps
                  + tr_rows * d * ps + E * 4 + d * 4 + 2 * d * 4)
        flops = 2 * E * d * d
        for with_agg, out in ((True, h), (False, h2)):
            kernel = (lambda: g1.fused_g1_edge_update_agg(*args)) if with_agg \
                else (lambda: g1.fused_g1_edge_update(*args))
            plain = (lambda: g1.g1_edge_update_agg_plain(*pargs)) if with_agg \
                else (lambda: g1.g1_edge_update_plain(*pargs))
            bms, by = bound_ms(nbytes + (N * d * 4 if with_agg else 0),
                               flops if es == 2 else 0,
                               flops_f32=0 if es == 2 else flops)
            err = max_err(out, h_ref)
            ok = err <= tol and bool(torch.isfinite(out.float()).all())
            ok = ok and bit_equal and alias_ok
            case = {"shape": shape + (" +agg" if with_agg else ""),
                    "max_err": err, "tol": tol, "tr_rows_read": tr_rows,
                    "bit_equal": bit_equal, "h_over_src": aliased,
                    "alias_ok": alias_ok}
            if with_agg:
                ok = ok and err_agg <= tol_agg
                case.update(agg_max_err=err_agg, agg_tol=tol_agg)
            cases.append({**case, "ok": ok,
                          **timed(torch, kernel, plain, large=large),
                          "bound_ms": bms, "bound_by": by})
    return cases


def check_ffn_backward(torch, ffn, T, d, seed, large=False, dtype=None):
    """The fused LN->FFN->residual backward at T bf16 (or ``dtype``) rows
    of width d against its plain version: dx within 2^-6 (f32: 1e-4) of
    its largest magnitude; the six parameter gradients within 1e-2 of
    theirs (f32 sums of products in another order, and a relu mask that may
    flip where the f32 pre-activation is within rounding of 0, in f32 too);
    and two launches bit-equal.  No single PyTorch call computes it, so
    ``library_ms`` is null."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    dt = dtype or torch.bfloat16
    es = 2 if dt == torch.bfloat16 else 4
    x = rnd(T, d)
    x[:3] = 0.0  # var == 0 rows
    args = (x.to(dt), 1 + 0.1 * rnd(d), 0.1 * rnd(d),
            (rnd(d, 4 * d) * d ** -0.5).to(dt), (0.1 * rnd(4 * d)).to(dt),
            (rnd(4 * d, d) * (4 * d) ** -0.5).to(dt), rnd(T, d).to(dt))
    kernel = lambda: ffn.ln_ffn_backward(*args)
    plain = lambda: ffn.ln_ffn_backward_plain(*args)
    with torch.no_grad():
        before = ffn.BWD_LAUNCHES
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if ffn.BWD_LAUNCHES != before + 1:
            raise SystemExit("ln_ffn_backward did not launch its kernel")
        names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
        rel = {n: max_err(o, r) / max(float(r.float().abs().max()), 1e-30)
               for n, o, r in zip(names, out, ref)}
        tols = dict(zip(names, (2.0 ** -6 if es == 2 else 1e-4,)
                        + (1e-2,) * 6))
        finite = all(bool(torch.isfinite(o.float()).all()) for o in out)
        err = max(max_err(o, r) for o, r in zip(out, ref))
        del ref
        again = kernel()
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        del out, again
        times = timed(torch, kernel, plain, large=large)
    # x, g in, dx out; both weights in, their gradients out (f32).
    nbytes = 3 * T * d * es + 2 * d * 4 * d * (es + 4) + 8 * d * 4
    # The five products the function needs: hp, dh, dW2, dW1, dxn.
    flops = 10 * T * d * 4 * d
    bms, by = (bound_ms(nbytes, flops) if es == 2
               else bound_ms(nbytes, 0, flops_f32=flops))
    return {"shape": f"T={T} d={d} {'bf16' if es == 2 else 'f32'}",
            "max_err": err, "rel_err": rel, "tol": tols,
            "bit_equal_relaunch": same,
            "ok": finite and same and all(rel[n] <= tols[n] for n in names),
            **times, "bound_ms": bms, "bound_by": by}


def check_random_gather(torch, rg, N, d, E, seed):
    """``random_gather`` of E random rows of an [N, d] bf16 table: bit-equal
    to its plain version.  ``library_ms``: ``index_select``.  The bound
    counts each table row once; the ids are uniform, so nearly every row is
    read."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(N, d, generator=gen).to(torch.bfloat16).cuda()
    idx = torch.randint(0, N, (E,), generator=gen).to(torch.int32).cuda()
    idx_long = idx.long()
    kernel = lambda: rg.random_gather(table, idx)
    plain = lambda: rg.random_gather_plain(table, idx)
    with torch.no_grad():
        before = rg.LAUNCHES
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if rg.LAUNCHES != before + 1:
            raise SystemExit("random_gather did not launch its kernel")
        ok = bool(torch.equal(out, ref))
        err = max_err(out, ref)
        del out, ref
        times = timed(torch, kernel, plain,
                      lambda: table.index_select(0, idx_long), large=True)
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * d * 2 + E * 4 + E * d * 2
    bms, by = bound_ms(nbytes, 0)
    return {"shape": f"table [{N}, {d}] bf16 -> {E} random rows",
            "max_err": err, "tol": 0.0, "ok": ok, **times, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes}


def large_graph(torch, pt, dtype=None):
    """``benchmarks/bench_large_graph.py``'s batch from seed 0: one graph,
    N = 65,536 nodes, E = 1,048,576 edges with sorted random receivers and
    random senders, features of width 256 on all three sets, bf16 (or
    ``dtype``) from one numpy stream."""
    rng = np.random.default_rng(0)
    N, E, d = LG_N, LG_E, LG_D
    senders = rng.integers(0, N, size=E).astype(np.int32)
    receivers = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    dev = "cuda"
    t = lambda a: torch.from_numpy(a).to(dev)
    feat = lambda *s: t(rng.normal(size=s).astype(np.float32)).to(
        dtype or torch.bfloat16)
    return pt.GraphsTuple(
        senders=t(senders), receivers=t(receivers),
        node_graph=torch.zeros(N, dtype=torch.int32, device=dev),
        edge_graph=torch.zeros(E, dtype=torch.int32, device=dev),
        n_node=torch.tensor([N], dtype=torch.int32, device=dev),
        n_edge=torch.tensor([E], dtype=torch.int32, device=dev),
        node_mask=torch.ones(N, dtype=torch.bool, device=dev),
        edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
        graph_mask=torch.ones(1, dtype=torch.bool, device=dev),
        ef=feat(E, d), nf=feat(N, d), gf=feat(1, d))


def want_counts(launches, expect, what):
    want = {k: 0 for k in launches}
    want.update(expect)
    if launches != want:
        raise SystemExit(f"{what} did not take the kernels as expected "
                         f"({want}): {launches}")


def out_loss(out):
    """The loss of a step's output (``make_train_step``'s metrics, or
    ``make_node_classification_step``'s loss)."""
    return out["loss"] if isinstance(out, dict) else out


def captured_check(torch, pt, build, args, lr, per_step, zero_counts,
                   read_counts, what):
    """``pt.capture_step`` of a training step against the same step run
    eagerly, from the same state (``build()`` makes the model and its step
    afresh from one seed) on the same batch: the loss within 1e-5 relative
    and every parameter after the step within 1e-5 of its largest
    magnitude plus a tenth of the learning rate (the rule of
    ``test_node_classification_trajectory_matches_jax``; the graph pools'
    f32 atomics allow no more); ten replays with finite losses; the
    captured and the eager step's times (CUDA events over 10 calls after
    3, the captured one's input copies and output clones included).  The
    counters, set to 0 before the first call, must read ``per_step`` times
    the calls that passed through the kernel wrappers (the warm-ups and
    the capture; a replay launches the captured kernels without them)."""
    model_c, step_c = build()
    model_e, step_e = build()
    cap = pt.capture_step(step_c)
    zero_counts()
    loss_c = float(out_loss(cap(*args)))
    torch.cuda.synchronize()
    launches = read_counts()
    want_counts(launches, {k: v * cap.traced_calls
                           for k, v in per_step.items()}, f"captured {what}")
    loss_e = float(out_loss(step_e(*args)))
    worst = (0.0, "")
    for (n, p), q in zip(model_c.named_parameters(), model_e.parameters()):
        if p.numel():
            bound = 1e-5 * float(q.abs().max()) + 0.1 * lr
            worst = max(worst, (float((p - q).abs().max()) / bound, n))
    rel = abs(loss_c - loss_e) / abs(loss_e)
    losses = [float(out_loss(cap(*args))) for _ in range(10)]
    log(f"captured {what}: {cap.captures} graph, {cap.traced_calls} calls "
        f"through the wrappers, launches {launches}; loss {loss_c:.7f} vs "
        f"eager {loss_e:.7f} ({rel:.3e} relative, tolerance 1e-5); worst "
        f"parameter {worst[1]} at {worst[0]:.4f} of its bound (1e-5 x its "
        f"largest magnitude + 0.1 x lr); losses of 10 replays {losses}")
    if (not np.isfinite(loss_c) or rel > 1e-5 or worst[0] > 1.0
            or not all(np.isfinite(losses))):
        raise SystemExit(f"the captured {what} disagrees with the eager one")
    captured_ms = cuda_ms(torch, lambda: cap(*args), iters=10)
    eager_ms = cuda_ms(torch, lambda: step_e(*args), iters=10)
    return {"launches": launches, "traced_calls": cap.traced_calls,
            "loss": loss_c, "eager_loss": loss_e, "loss_rel": rel,
            "worst_param": worst, "replay_losses": losses,
            "captured_ms": captured_ms, "eager_ms": eager_ms,
            **profile_replay(torch, lambda: cap(*args))}


def large_forward_phase(torch, pt, g, zero_counts, read_counts, tol=5e-2,
                        what="large-graph forward"):
    """Phase C, forward: 3 GNCores at (256, 256, 256) with seeded params of
    the large graph's feature type; counters set to 0 just before and read
    just after; the output against the pure route on the card within
    ``tol`` of each feature set's largest magnitude; eager and CUDA-graph
    times."""
    d = LG_D
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((d, d, d), generator=gen)
                           for _ in range(LG_CORES)]).to(g.ef.dtype)
    pt.enable_kernels(True)
    with torch.no_grad():
        zero_counts()
        y = model(g)
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"{what} launches: {launches}")
        want_counts(launches, dict(edge_g1_agg=LG_CORES, ffn=2 * LG_CORES),
                    what)
        fwd_ms = cuda_ms(torch, lambda: model(g), iters=LARGE_ITERS, warmup=1)
        fwd_graph_ms = graph_ms(torch, lambda: model(g), iters=3)
        prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: model(g))
        pt.enable_kernels(False)
        y_pure = model(g)
        pure_ms = cuda_ms(torch, lambda: model(g), iters=3, warmup=1)
        pt.enable_kernels(True)
        path_err = {}
        for key in ("ef", "nf", "gf"):
            a, r = getattr(y, key).float(), getattr(y_pure, key).float()
            if a.shape != r.shape or not bool(torch.isfinite(a).all()):
                raise SystemExit(f"{what} {key}: bad shape or non-finite")
            path_err[key] = float((a - r).abs().max() / r.abs().max())
    log(f"{what} vs pure route (max err / max |ref|): {path_err}, "
        f"tolerance {tol}")
    if max(path_err.values()) > tol:
        raise SystemExit(f"{what} disagrees with the pure route")
    return {"launches": launches, "fwd_ms": fwd_ms,
            "fwd_graph_ms": fwd_graph_ms, "pure_ms": pure_ms,
            "prof_rows": prof_rows, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "path_err": path_err}


def loss_and_grads(torch, pt, model, x, y, compute_dtype=None):
    """Loss and parameter gradients of ``graph_loss_nf_ef(model(x), y)``
    under training, the parameters cast to ``compute_dtype`` for the
    forward as ``make_train_step`` casts them.  The pure-route twins of the
    large-graph step are ``GNCoreList(remat=True)`` models: their saved
    [E, 4d] activations would not fit beside each other in f32, and under
    ``remat`` one core's are alive at a time."""
    from torch.func import functional_call
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    run = params if compute_dtype is None else {
        n: p.to(compute_dtype) for n, p in params.items()}
    loss = pt.graph_loss_nf_ef(
        functional_call(model, run, (x,), {"training": True}), y)
    loss.backward()
    return float(loss.detach()), {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad) for n, p in params.items()}


def large_train_phase(torch, pt, g, zero_counts, read_counts):
    """Phase C, training: ``benchmarks/bench_large_graph.py --mode train``
    (f32 masters, bf16 compute, random bf16 node and edge targets,
    ``graph_loss_nf_ef``, AdamW(3e-4)) through ``make_train_step``.  Loss
    and gradients against the pure route's f32 twin; 3 finite losses; then one step with ``g1_agg_fusion_training`` off (the
    benchmark's ``--g1-agg 0``), which takes the kernel without the sum."""
    import copy
    from graphnets_tpu_torch.utils.config import get_config
    d, E, N = LG_D, LG_E, LG_N
    rng = np.random.default_rng(1)
    target = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(device=g.device, dtype=torch.bfloat16)
    y = g.with_features(ef=target(E, d), nf=target(N, d), gf=None)
    gen = torch.Generator().manual_seed(0)
    model = pt.GNCoreList([pt.GNCore((d, d, d), generator=gen)
                           for _ in range(LG_CORES)])
    twin, remat = copy.deepcopy(model), copy.deepcopy(model)
    twin.remat = remat.remat = True
    step = pt.make_train_step(model, pt.adamw(model.parameters(), 3e-4),
                              compute_dtype=torch.bfloat16)
    remat_step = pt.make_train_step(remat, pt.adamw(remat.parameters(), 3e-4),
                                    compute_dtype=torch.bfloat16)
    pt.enable_kernels(True)
    # The kernel route's step with every core under remat, from the same
    # state: its peak memory, and its loss and gradients against the step
    # without remat below.
    gib = lambda b: b / 2 ** 30
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    m_remat = remat_step(g, y)
    torch.cuda.synchronize()
    remat_launches = read_counts()
    remat_peak_gb = gib(torch.cuda.max_memory_allocated())
    remat_own_gb = gib(torch.cuda.max_memory_allocated() - base)
    remat_grads = grads_of(torch, remat)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    m = step(g, y)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gb = gib(torch.cuda.max_memory_allocated())
    own_gb = gib(torch.cuda.max_memory_allocated() - base)
    log(f"large-graph train step launches: {launches}")
    want_counts(launches, dict(edge_g1_agg=LG_CORES, ffn=2 * LG_CORES,
                               ffn_backward=2 * LG_CORES,
                               ln_backward=LG_CORES,
                               segment_sum=2 * LG_CORES, gather=LG_CORES),
                "large-graph train step")
    grads = grads_of(torch, model)
    loss, remat_loss = float(m["loss"]), float(m_remat["loss"])
    remat_worst = max((float((remat_grads[n] - t).abs().max())
                       / max(float(t.abs().max()), 1e-30), n)
                      for n, t in grads.items())
    log(f"large-graph train step with remat: launches {remat_launches}; "
        f"loss {remat_loss:.6f} vs {loss:.6f} without (tolerance 1e-5 "
        f"relative); worst gradient {remat_worst[1]} off by "
        f"{remat_worst[0]:.3e} of its largest magnitude (tolerance 1e-2); "
        f"peak device memory {remat_peak_gb:.4f} GiB against {peak_gb:.4f} "
        f"GiB without, of which the step's own (above what was allocated "
        f"before it) {remat_own_gb:.4f} against {own_gb:.4f} GiB")
    if (abs(remat_loss - loss) > 1e-5 * abs(loss) or remat_worst[0] > 1e-2
            or remat_launches["edge_g1_agg"] != 2 * LG_CORES):
        raise SystemExit("the large-graph step with remat disagrees with "
                         "the step without, or did not recompute each core")
    del remat_grads
    pt.enable_kernels(False)
    pure_loss, pure = loss_and_grads(torch, pt, twin, g, y, torch.bfloat16)
    pure = {n: t.clone() for n, t in pure.items()}
    f32 = lambda t: t.float()
    f32_loss, grads32 = loss_and_grads(
        torch, pt, twin,
        g.with_features(ef=f32(g.ef), nf=f32(g.nf), gf=f32(g.gf)),
        y.with_features(ef=f32(y.ef), nf=f32(y.nf)))
    torch.cuda.synchronize()
    pt.enable_kernels(True)
    # Phase 4b holds the kernel route to the pure bf16 route, by the largest
    # element of the difference, within the larger of 5e-2 of the tensor's
    # largest magnitude and the pure route's own bf16-vs-f32 distance.  Here
    # that rule fails (its worst share is logged below): the largest of up
    # to 262,144 differences, each a sum over 1,048,576 rows rounded in
    # other places on the two routes, is a tail value, up to 1.9 times as
    # far from f32 on one route as on the other where the tensors as wholes
    # are equally far.  So the f32 twin is the reference and the distance is
    # the 2-norm over the tensor: the kernel route may be no further from
    # the twin than 5e-2 of the twin's norm or G1_F32_SLACK times the pure
    # bf16 route's distance from it.  The loss likewise (its targets are
    # random normals, so it is a sum with heavy cancellation: about -2.4
    # from terms of order 100).
    share = lambda e, b: e / b if b > 0 else float(e > 0)
    rows = []
    for n, p in pure.items():
        ref, k = grads32[n], grads[n]
        dist, pure_dist = float((k - ref).norm()), float((p - ref).norm())
        bound = max(5e-2 * float(ref.norm()), G1_F32_SLACK * pure_dist)
        top, pure_top = (float((t - ref).abs().max()) for t in (k, p))
        bound_4b = max(5e-2 * float(p.abs().max()), pure_top)
        rows.append((share(dist, bound), n, dist, pure_dist,
                     share(top, pure_top),
                     share(float((k - p).abs().max()), bound_4b)))
    rows.sort(reverse=True)
    worst = rows[0][:2]
    worst_top = max((r[4], r[1]) for r in rows)
    worst_4b = max((r[5], r[1]) for r in rows)
    log(f"large-graph train step: loss {loss:.6f}, pure route "
        f"{pure_loss:.6f} in bf16 and {f32_loss:.6f} in f32; gradients "
        f"furthest from the f32 twin (share of bound, tensor, |kernel - "
        f"f32|_2, |pure bf16 - f32|_2): "
        f"{[(round(r[0], 4), r[1], r[2], r[3]) for r in rows[:6]]}; by the "
        f"largest element the kernel route is at most {worst_top[0]:.4f} "
        f"times as far from f32 as the pure bf16 route ({worst_top[1]}); "
        f"under phase 4b's rule against the pure bf16 route the worst share "
        f"would be {worst_4b[0]:.4f} ({worst_4b[1]}) and the loss "
        f"{abs(loss - pure_loss) / abs(pure_loss):.4f} relative")
    loss_bound = max(1e-2 * abs(f32_loss),
                     G1_F32_SLACK * abs(pure_loss - f32_loss))
    if (abs(loss - f32_loss) > loss_bound or worst[0] > 1.0
            or not all(bool(torch.isfinite(t).all()) for t in grads.values())):
        raise SystemExit(f"large-graph train step disagrees with the f32 "
                         f"twin: loss {loss} vs {f32_loss} (pure bf16 "
                         f"{pure_loss}), worst gradient {worst}")
    del grads, grads32, pure
    losses = [loss] + [float(step(g, y)["loss"]) for _ in range(2)]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite large-graph train loss: {losses}")
    step_ms = cuda_ms(torch, lambda: step(g, y), iters=3, warmup=0)
    prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: step(g, y))
    pt.enable_kernels(False)
    pure_step_ms = cuda_ms(
        torch, lambda: loss_and_grads(torch, pt, twin, g, y, torch.bfloat16),
        iters=2, warmup=0)
    pt.enable_kernels(True)
    remat_step_ms = cuda_ms(torch, lambda: remat_step(g, y), iters=3,
                            warmup=0)
    # The same step with the fused edge->node sum off under training.
    cfg = get_config()
    cfg.g1_agg_fusion_training = False
    try:
        zero_counts()
        m_off = step(g, y)
        torch.cuda.synchronize()
        off_launches = read_counts()
        log(f"large-graph train step launches, fused sum off: {off_launches}")
        want_counts(off_launches,
                    dict(edge_g1=LG_CORES, ffn=2 * LG_CORES,
                         ffn_backward=2 * LG_CORES, ln_backward=LG_CORES,
                         segment_sum=3 * LG_CORES, gather=LG_CORES),
                    "large-graph train step with the fused sum off")
        if not np.isfinite(float(m_off["loss"])):
            raise SystemExit("non-finite loss with the fused sum off")
        off_step_ms = cuda_ms(torch, lambda: step(g, y), iters=3, warmup=0)
    finally:
        cfg.g1_agg_fusion_training = True
    return {"launches": launches, "off_launches": off_launches, "loss": loss,
            "pure_loss": pure_loss, "f32_loss": f32_loss, "worst_grad": worst,
            "worst_grad_4b": worst_4b, "worst_grad_top": worst_top,
            "losses": losses,
            "step_ms": step_ms, "pure_step_ms": pure_step_ms,
            "off_step_ms": off_step_ms, "prof_rows": prof_rows,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "peak_gb": peak_gb,
            "remat_launches": remat_launches, "remat_loss": remat_loss,
            "remat_worst_grad": remat_worst, "remat_peak_gb": remat_peak_gb,
            "own_gb": own_gb, "remat_own_gb": remat_own_gb,
            "remat_step_ms": remat_step_ms}


# Phase F: the fused FFN pair on f32 rows at the shapes phase F gives it
# (the headline's edge rows, C's edge and node rows) and the rest of the
# gate's widths, forward and backward.
F_FFN_FWD = ((16384, 384), (LG_E, LG_D), (LG_N, LG_D), (1024, 384),
             (8, 384))
F_FFN_BWD = ((LG_N, LG_D), (LG_E, LG_D), (LG_N, 128), (LG_N, 512))


def f32_ffn_cases(torch, ffn):
    """The fused FFN forward and backward on f32 rows at ``F_FFN_FWD`` and
    ``F_FFN_BWD`` against their plain versions (phase 3's tolerances:
    forward 1e-5, dx 1e-4, the parameter gradients 1e-2 of the largest
    magnitude), each bit-equal on a second launch."""
    f32 = torch.float32
    fwd = [check_ffn(torch, ffn, T, 90 + i, D=d, large=T >= LG_E, dtype=f32)
           for i, (T, d) in enumerate(F_FFN_FWD)]
    bwd = [check_ffn_backward(torch, ffn, T, d, 96 + i, large=T >= LG_E,
                              dtype=f32)
           for i, (T, d) in enumerate(F_FFN_BWD)]
    return fwd, bwd


def log_f32_ffn(cases, where, what=None):
    for c in cases:
        kind = what or ("backward" if "rel_err" in c else "forward")
        passes = c.get("pass_ms")
        split = ("" if passes is None else
                 f" (row pass {passes['rows']:.4f}, dW pass "
                 f"{passes['dw']:.4f}, its sums {passes['reduction']:.4f})")
        log(f"f32 {kind} {c['shape']}: {c['kernel_ms']:.4f} ms{split}, "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_ms'] / c['kernel_ms']:.3f}"
            f" of it), plain {c['plain_ms']:.4f} ms; ok {c['ok']}; {where}")


# Phase F: the f32 LN->matmul backward and single-graph edge update at the
# shapes F(b) gives them (C's edge rows and graph), and at the sort task's
# and a sampled subgraph's (f32 partials, power-law receivers).
F_SORT_ROWS, F_SORT_D = 512, 384
F_G1_SMALL = (65536, 4096)


def f32_row_cases(torch, ll, lnp, g1, small=True):
    """The f32 LN->matmul backward at T = LG_E, d = dout = LG_D and the
    f32 single-graph edge update at E = LG_E, N = LG_N, LG_D -> LG_D, f32
    partials, uniform receivers, with and without the edge->node sum
    (F(b)'s shapes), and with ``small`` also at ``F_SORT_ROWS`` /
    ``F_SORT_D`` and ``F_G1_SMALL``: against their plain versions under
    phase 3's tolerances (``check_ln_backward``, ``check_g1``), each
    bit-equal on a second launch."""
    f32 = torch.float32
    ln = [check_ln_backward(torch, ll, lnp, LG_E, 68, f32, D=LG_D,
                            large=True)]
    g1_cases = check_g1(torch, g1, LG_E, LG_N, LG_D, f32, f32, "uniform", 69,
                        large=True)
    if small:
        ln.append(check_ln_backward(torch, ll, lnp, F_SORT_ROWS, 34, f32,
                                    D=F_SORT_D))
        g1_cases += check_g1(torch, g1, *F_G1_SMALL, LG_D, f32, f32,
                             "power", 52)
    return ln, g1_cases


def f32_large_train_phase(torch, pt, g, zero_counts, read_counts):
    """Phase F(b), training: C's step at the JAX package's default
    precision: f32 parameters, features and targets (C's targets from the
    same numpy stream), no compute-dtype cast, AdamW(3e-4), through
    ``make_train_step``.  The launches of one step; its loss and gradients
    against a pure-route f32 twin under ``remat`` from the same weights
    (loss 1e-5 relative; each gradient within 1e-3 of the twin's in the
    2-norm, C's million-row rule: relu masks flip within f32 order noise);
    its peak memory; eager, captured and device times.

    The pure route sums f32 rows with atomics, so its gradients move from
    run to run by f32 order noise, and with them the relu masks of
    pre-activations within rounding of 0: the kernel route's 2-norm gap
    to the twin measured 5.5e-4 to 9.6e-4 over seven runs (worst on the
    node FFNs).  Beside the 1e-3 rule the same run therefore measures a
    witness of that noise, the twin on the same graph with each
    receiver's edges in another order (the same function, other
    summation orders), and a gradient may also lie within twice the
    witness's gap in its tensor."""
    import copy
    d, E, N = LG_D, LG_E, LG_N
    rng = np.random.default_rng(1)
    target = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(g.device)
    y = g.with_features(ef=target(E, d), nf=target(N, d), gf=None)

    def build():
        gen = torch.Generator().manual_seed(0)
        m = pt.GNCoreList([pt.GNCore((d, d, d), generator=gen)
                           for _ in range(LG_CORES)])
        return m, pt.make_train_step(m, pt.adamw(m.parameters(), 3e-4))

    model, step = build()
    twin = copy.deepcopy(model)
    twin.remat = True
    pt.enable_kernels(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    m = step(g, y)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    own_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"F(b) f32 train step launches: {launches}")
    per_step = dict(edge_g1_agg=LG_CORES, ffn=2 * LG_CORES,
                    ffn_backward=2 * LG_CORES, ln_backward=LG_CORES,
                    segment_sum=2 * LG_CORES, gather=LG_CORES)
    want_counts(launches, per_step, "F(b) f32 train step")
    grads = grads_of(torch, model)
    loss = float(m["loss"])
    pt.enable_kernels(False)
    pure_loss, pure = loss_and_grads(torch, pt, twin, g, y)
    pure = {n: t.clone() for n, t in pure.items()}
    # The witness: each receiver's edges shuffled within its run.
    perm = torch.from_numpy(np.lexsort((
        np.random.default_rng(5).random(E),
        g.receivers.cpu().numpy()))).to(g.device)
    _, wit = loss_and_grads(
        torch, pt, twin,
        g.replace(senders=g.senders[perm]).with_features(ef=g.ef[perm]),
        y.replace(senders=g.senders[perm]).with_features(ef=y.ef[perm]))
    del perm
    torch.cuda.synchronize()
    pt.enable_kernels(True)
    gap = lambda a, b: float((a - b).norm()) / max(float(b.norm()), 1e-30)
    rows = sorted(((gap(grads[n], t), n, gap(wit[n], t))
                   for n, t in pure.items()), reverse=True)
    worst = max((r[0] / max(1e-3, 2 * r[2]), r[1]) for r in rows)
    loss_rel = abs(loss - pure_loss) / abs(pure_loss)
    log(f"F(b) f32 train step vs the pure-route f32 twin: loss {loss:.7f} "
        f"vs {pure_loss:.7f} ({loss_rel:.3e} relative, tolerance 1e-5); "
        f"gradients furthest from the twin's (|kernel - pure|_2 / "
        f"|pure|_2, tensor, the witness's gap): {rows[:5]}; the witness's "
        f"largest gap {max(r[2] for r in rows):.3e}; worst share of the "
        f"bound (the larger of 1e-3 and twice the witness's gap) "
        f"{worst[0]:.4f} ({worst[1]})")
    if (loss_rel > 1e-5 or worst[0] > 1.0
            or not all(bool(torch.isfinite(t).all()) for t in grads.values())):
        raise SystemExit(f"the F(b) f32 train step disagrees with its pure "
                         f"twin: loss {loss} vs {pure_loss}, worst gradient "
                         f"{worst}")
    del grads, pure, wit, twin
    losses = [loss] + [float(step(g, y)["loss"]) for _ in range(2)]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite F(b) f32 train loss: {losses}")
    step_ms = cuda_ms(torch, lambda: step(g, y), iters=3, warmup=0)
    prof_rows, busy_ms, wall_ms = profile_forward(torch, lambda: step(g, y))
    del model, step
    torch.cuda.empty_cache()
    captured = captured_check(torch, pt, build, (g, y), 3e-4, per_step,
                              zero_counts, read_counts, "F(b) f32 train step")
    torch.cuda.empty_cache()
    return {"launches": launches, "captured_launches": captured["launches"],
            "loss": loss, "pure_loss": pure_loss, "loss_rel": loss_rel,
            "worst_grad": rows[0], "worst_share": worst,
            "witness_gap": max(r[2] for r in rows), "losses": losses,
            "step_ms": step_ms,
            "prof_rows": prof_rows, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "peak_gb": peak_gb, "own_gb": own_gb,
            "captured_ms": captured["captured_ms"],
            "captured_eager_ms": captured["eager_ms"],
            "replay_busy_ms": captured["replay_busy_ms"],
            "replay_kernels": captured["replay_kernels"]}


def f32_phase(torch, pt, zero_counts, read_counts, where):
    """Phase F: the JAX package's default precision (``Policy()`` computes
    in f32) on the card.  (a) ``bench.py``'s headline forward with f32
    parameters and features; (b) C's graph with f32 features from the same
    numpy stream: the forward, then the train step of
    :func:`f32_large_train_phase`.  Both routes' f32 products run without
    TF32, as JAX's CPU reference does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = pt.batch(bench_graphs(0, N_PER_G, DEG, N_PER_G, N_PER_G * DEG),
                 pad=pt.PadSpec.uniform(N_PER_G, N_PER_G * DEG))
    if g.ef.dtype != torch.float32:
        raise SystemExit("phase F: the headline batch is not f32")
    # The fused edge update's gate is bf16 only: f32 rows take the split
    # linear route (ln_matmul, sorted_gather_add of the receivers term,
    # the sorted sum), as JAX's GNBlock does on the same batch.
    fa = forward_phase(torch, pt, g,
                       dict(ln_matmul=N_CORES, gather_add=N_CORES,
                            segment_sum=N_CORES, ffn=3 * N_CORES),
                       zero_counts, read_counts, "F(a) f32 forward",
                       dtype=torch.float32, tol=1e-4)
    log_forward("F(a) f32 forward", fa, int(g.n_edge.sum()), where)
    del g
    gl = large_graph(torch, pt, torch.float32)
    fb_fwd = large_forward_phase(torch, pt, gl, zero_counts, read_counts,
                                 tol=1e-4, what="F(b) f32 forward")
    log(f"F(b) f32 forward (N={LG_N} E={LG_E} D={LG_D}, {LG_CORES} "
        f"cores): {fb_fwd['fwd_ms']:.4f} ms eager, "
        f"{fb_fwd['fwd_graph_ms']:.4f} ms as a CUDA graph, kernel route; "
        f"pure route {fb_fwd['pure_ms']:.4f} ms eager; profile of one "
        f"forward: {sum(r[1] for r in fb_fwd['prof_rows'])} kernels, "
        f"{fb_fwd['busy_ms']:.4f} ms of {fb_fwd['wall_ms']:.4f} ms wall; "
        f"{where}")
    for dev_ms, count, name in fb_fwd["prof_rows"][:8]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    fb = f32_large_train_phase(torch, pt, gl, zero_counts, read_counts)
    log(f"F(b) f32 train step: {fb['step_ms']:.4f} ms eager, captured "
        f"{fb['captured_ms']:.4f} ms [eager twin {fb['captured_eager_ms']:.4f}"
        f" ms]; one profiled replay {fb['replay_kernels']} kernels of "
        f"{fb['replay_busy_ms'] or 0:.4f} ms, busy share "
        f"{busy_share(fb['replay_busy_ms'], fb['captured_ms'])}; profile of "
        f"one eager step: {sum(r[1] for r in fb['prof_rows'])} kernels, "
        f"{fb['busy_ms']:.4f} ms of {fb['wall_ms']:.4f} ms wall; peak device "
        f"memory {fb['peak_gb']:.4f} GiB ({fb['own_gb']:.4f} the step's "
        f"own); losses {fb['losses']}; {where}")
    for dev_ms, count, name in fb["prof_rows"][:12]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    del gl
    torch.cuda.empty_cache()
    slim = lambda r: {k: v for k, v in r.items() if k != "prof_rows"}
    return {"a": slim(fa), "b_forward": slim(fb_fwd), "b_train": slim(fb)}


def arxiv_shaped_graph(pt, seed=0):
    """``benchmarks/bench_arxiv.py``'s synthetic graph: 169,343 nodes,
    1,166,243 directed edges with power-law in-degree over shuffled ranks,
    128-d features correlated with 40 classes."""
    rng = np.random.default_rng(seed)
    N, E = AX_N, AX_E
    ranks = rng.permutation(N).astype(np.int32)
    p = 1.0 / (np.arange(N) + 10.0)
    cdf = np.cumsum(p / p.sum())
    receivers = ranks[np.searchsorted(
        cdf, rng.random(E), side="right").clip(0, N - 1)]
    senders = rng.integers(0, N, size=E, dtype=np.int32)
    labels = rng.integers(0, AX_CLASSES, size=N)
    feat = rng.normal(size=(N, AX_FEAT)).astype(np.float32)
    feat[:, :AX_CLASSES] += 2.0 * np.eye(AX_CLASSES, dtype=np.float32)[labels]
    return pt.LargeGraph.from_coo(senders, receivers, feat,
                                  labels.astype(np.int64))


def sampled_batch(pt, graph):
    """The first batch of phase D's sampler (the same seed and seeds):
    56,960 node / 56,320 edge slots whose receivers ascend and end in the
    pad node's ~51,670 pad edges."""
    sampler = pt.NeighborSampler(graph, fanouts=AX_FANOUTS,
                                 batch_size=AX_BATCH, seed=1,
                                 emit_node_ids=True)
    return next(sampler.epoch(np.arange(graph.num_nodes)))


def sampled_phase(torch, pt, zero_counts, read_counts, graph, build_s):
    """Phase D: sampled training on the arxiv-shaped graph
    (``benchmarks/bench_arxiv.py``): ``NeighborSampler((10, 10), batch 512,
    emit_node_ids)`` -> ``EncodeProcessDecode((0, 128, 0) -> (256,) * 3 ->
    (1, 40, 0))`` with 2 cores, bf16 compute with f32 masters, Adam(1e-3),
    through ``make_node_classification_step``: 1 + 10 steps.  The first
    step's loss against the pure route (the same init and batch) within
    2e-2 relative and its gradients under phase 4b's rule; every loss
    finite, with the pure route's losses on the same batches beside them; the single-graph kernel launched
    twice a step."""
    import copy
    sampler = pt.NeighborSampler(graph, fanouts=AX_FANOUTS,
                                 batch_size=AX_BATCH, seed=1,
                                 emit_node_ids=True)
    feat = pt.device_feature_table(graph, torch.bfloat16)
    model = pt.EncodeProcessDecode(
        (0, AX_FEAT, 0), (AX_HIDDEN,) * 3, (1, AX_CLASSES, 0),
        n_cores=AX_CORES, generator=torch.Generator().manual_seed(0))
    twin, twin32 = copy.deepcopy(model), copy.deepcopy(model)
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-8)
    step = pt.make_node_classification_step(
        model, adam(model), AX_CLASSES, compute_dtype=torch.bfloat16)
    pure_step = pt.make_node_classification_step(
        twin, adam(twin), AX_CLASSES, compute_dtype=torch.bfloat16)
    f32_step = pt.make_node_classification_step(twin32, adam(twin32),
                                                AX_CLASSES)
    it = sampler.epoch(np.arange(graph.num_nodes))
    batches, sample_s = [], []
    for _ in range(1 + AX_STEPS):
        t0 = time.perf_counter()
        batches.append(next(it))
        sample_s.append(time.perf_counter() - t0)
    b0 = batches[0]
    shape = (b0.graph.num_node_slots, b0.graph.num_edge_slots,
             int(b0.graph.n_node[0]), int(b0.graph.n_edge[0]))
    log(f"sampled subgraph: {shape[0]} node slots ({shape[2]} real), "
        f"{shape[1]} edge slots ({shape[3]} real); graph build "
        f"{build_s:.4f} s")
    if shape[:2] != (56960, 56320):
        raise SystemExit(f"unexpected sampled capacities: {shape}")
    run = lambda fn, b: fn(b.graph, b.node_ids, b.labels, b.label_mask,
                           b.seed_local_idx, feat)
    pt.enable_kernels(True)
    zero_counts()
    loss0 = float(run(step, b0))
    first_launches = read_counts()
    grads = grads_of(torch, model)
    pt.enable_kernels(False)
    pure0 = float(run(pure_step, b0))
    f32_0 = float(f32_step(b0.graph, b0.node_ids, b0.labels, b0.label_mask,
                           b0.seed_local_idx, feat.float()))
    pt.enable_kernels(True)
    # The backward of this route (the single-graph kernel's with f32
    # partials, the chunked sorted sum over the pad node's segment): the
    # first step's gradients under phase 4b's rule.
    pure, grads32 = grads_of(torch, twin), grads_of(torch, twin32)
    ratios = {}
    for n, t in pure.items():
        if t.numel() == 0:  # the encoder's parts for the width-0 sets
            continue
        bound = max(5e-2 * float(t.abs().max()),
                    float((t - grads32[n]).abs().max()))
        err = float((grads[n] - t).abs().max())
        ratios[n] = err / bound if bound > 0 else float(err > 0)
    worst = max((r, n) for n, r in ratios.items())
    log(f"sampled step 1 launches: {first_launches}; loss {loss0:.6f} vs "
        f"pure route {pure0:.6f} (tolerance 2e-2 relative; f32 twin "
        f"{f32_0:.6f}); worst gradient {worst[1]} at {worst[0]:.4f} of its "
        f"bound (max of 5e-2 x its largest magnitude and the pure route's "
        f"bf16-vs-f32 distance)")
    if (not np.isfinite(loss0) or abs(loss0 - pure0) > 2e-2 * abs(pure0)
            or worst[0] > 1.0
            or not all(bool(torch.isfinite(t).all()) for t in grads.values())):
        raise SystemExit("sampled step disagrees with the pure route")
    del grads
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [run(step, b) for b in batches[1:]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / AX_STEPS * 1e3
    launches = read_counts()
    losses = [loss0] + [float(v) for v in losses]
    # The pure route's trajectory on the same batches, for the record: the
    # two routes' parameters part after Adam's first (sign-like) update, so
    # the later losses are printed side by side and not held to each other.
    pt.enable_kernels(False)
    pure_losses = [pure0] + [float(run(pure_step, b)) for b in batches[1:]]
    pt.enable_kernels(True)
    log(f"sampled train launches over {AX_STEPS} steps: {launches}; losses "
        f"{losses}; pure route on the same batches {pure_losses}")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite sampled train loss: {losses}")
    if (first_launches["edge_g1_agg"] != AX_CORES
            or launches["edge_g1_agg"] != AX_CORES * AX_STEPS
            or any(launches[k] != first_launches[k] * AX_STEPS
                   for k in launches)):
        raise SystemExit("sampled training did not launch the single-graph "
                         f"kernel twice a step: {launches}")
    prof_rows, busy_ms, wall_ms = profile_forward(
        torch, lambda: run(step, batches[-1]))
    pt.enable_kernels(False)
    pure_ms = cuda_ms(torch, lambda: run(pure_step, batches[-1]), iters=5,
                      warmup=1)
    pt.enable_kernels(True)
    return {"launches": launches, "first_launches": first_launches,
            "losses": losses, "pure_losses": pure_losses,
            "worst_grad": worst, "step_ms": step_ms,
            "sample_ms": float(np.mean(sample_s[1:]) * 1e3),
            "pure_step_ms": pure_ms, "prof_rows": prof_rows,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "shape": shape,
            "graph_build_s": build_s}


# Phase E: prefetch workers and the batches each produces.
E_WORKERS, E_BATCHES = 2, 16


def pipeline_phase(torch, pt, zero_counts, read_counts, graph, per_step):
    """Phase E: sampled training as the JAX package runs it, at phase D's
    shape: the native sampler (it must be built), batches from a
    ``PrefetchPool`` of ``E_WORKERS`` workers whose samplers emit pinned
    CPU batches that the workers copy to the card on streams of their own,
    and the step captured as a CUDA graph (``capture_step`` of
    ``make_node_classification_step``, Adam(1e-3), bf16 compute).  Checks:
    the captured step against the eager one (:func:`captured_check`), the
    pool's batches element for element against in-line native samplers
    with the same seeds, every pipeline loss finite, and the launch
    counters (0 before the pipeline's capture, read after its last step)
    ``per_step`` times the calls through the wrappers.  Times: the native
    sampler's ms a batch beside the numpy path's, the captured step beside
    the eager one, the pipeline's seeds/s beside the same captured step fed
    by an in-line sampler, and the busy share."""
    import itertools
    import os
    from graphnets_tpu_torch.runtime import native
    from graphnets_tpu_torch.utils.tree import tensors
    if not native.available():
        raise SystemExit("phase E needs the native runtime")
    seeds = np.arange(graph.num_nodes)

    def sampler(seed, **kw):
        return pt.NeighborSampler(graph, fanouts=AX_FANOUTS,
                                  batch_size=AX_BATCH, seed=seed,
                                  emit_node_ids=True, **kw)

    def batch_ms(n):
        it = sampler(1, device="cpu").epoch(seeds)
        next(it)  # the epoch's shuffle
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        return (time.perf_counter() - t0) / n * 1e3

    native_ms = batch_ms(10)
    old = os.environ.get("GRAPHNETS_TPU_TORCH_NATIVE")
    os.environ["GRAPHNETS_TPU_TORCH_NATIVE"] = "0"
    try:
        numpy_ms = batch_ms(3)
    finally:
        if old is None:
            del os.environ["GRAPHNETS_TPU_TORCH_NATIVE"]
        else:
            os.environ["GRAPHNETS_TPU_TORCH_NATIVE"] = old
    log(f"sampler, a batch of {AX_BATCH} seeds at fanouts {AX_FANOUTS}: "
        f"native {native_ms:.4f} ms ({native.library_path().name}, "
        f"{os.cpu_count()} threads), numpy path {numpy_ms:.4f} ms")

    feat = pt.device_feature_table(graph, torch.bfloat16)
    args = lambda b: (b.graph, b.node_ids, b.labels, b.label_mask,
                      b.seed_local_idx, feat)

    def build():
        model = pt.EncodeProcessDecode(
            (0, AX_FEAT, 0), (AX_HIDDEN,) * 3, (1, AX_CLASSES, 0),
            n_cores=AX_CORES, generator=torch.Generator().manual_seed(0))
        return model, pt.make_node_classification_step(
            model, pt.adam(model.parameters(), 1e-3), AX_CLASSES,
            compute_dtype=torch.bfloat16)

    pt.enable_kernels(True)
    b0 = next(sampler(1, device="cuda").epoch(seeds))
    check = captured_check(torch, pt, build, args(b0), 1e-3, per_step,
                           zero_counts, read_counts, "sampled step")

    # The pipeline: the step is captured before the workers start (a
    # capture refuses the allocations of other threads).
    _, step = build()
    cap = pt.capture_step(step)
    zero_counts()
    cap(*args(b0))
    torch.cuda.synchronize()

    def factory(wid):
        it = sampler(100 + wid, device="cpu", pin_memory=True).epoch(seeds)
        for i, b in enumerate(itertools.islice(it, E_BATCHES)):
            yield wid, i, b

    got, losses = [], []
    t0 = time.perf_counter()
    for wid, i, b in pt.PrefetchPool(factory, num_workers=E_WORKERS):
        losses.append(cap(*args(b)))
        got.append((wid, i, b))
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) / len(got) * 1e3
    launches = read_counts()
    want_counts(launches, {k: v * cap.traced_calls
                           for k, v in per_step.items()}, "phase E")
    losses = [float(v) for v in losses]
    if len(got) != E_WORKERS * E_BATCHES or not all(np.isfinite(losses)):
        raise SystemExit(f"phase E: {len(got)} batches, losses {losses}")
    ref = {w: list(itertools.islice(
        sampler(100 + w, device="cpu").epoch(seeds), E_BATCHES))
        for w in range(E_WORKERS)}
    for wid, i, b in got:
        want = tensors(ref[wid][i])
        have = tensors(b)
        if len(want) != len(have) or not all(
                h.is_cuda and torch.equal(h.cpu(), w)
                for h, w in zip(have, want)):
            raise SystemExit(f"phase E: batch {i} of worker {wid} differs "
                             f"from the in-line sampler's")

    # The same captured step fed by one in-line native sampler on the card.
    it = sampler(200, device="cuda").epoch(seeds)
    next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(E_BATCHES):
        cap(*args(next(it)))
    torch.cuda.synchronize()
    inline_ms = (time.perf_counter() - t0) / E_BATCHES * 1e3
    replay_ms = cuda_ms(torch, lambda: cap(*args(b0)), iters=10)
    return {"native_ms": native_ms, "numpy_ms": numpy_ms, "check": check,
            "launches": launches, "losses": losses, "pipe_ms": pipe_ms,
            "inline_ms": inline_ms, "replay_ms": replay_ms,
            "batches": len(got), "replays": cap.replays}


# Phase P: data, tensor and pipeline parallelism over torch.distributed.
P_LR = 3e-4
P_MICROS = 3            # the pipeline's microbatches
P_STAGE_CORES = 2       # the pipeline's cores, one a stage
P_TIMEOUT_S = 300       # every rank's collectives and its join
# The flagship recipe (benchmarks/run_flagship.py) and its JAX records
# (benchmarks/flagship_f32.json, flagship_cosine.json: eval graph_acc).
FLAGSHIP_STEPS, FLAGSHIP_EVAL = 20_000, 1024
FLAGSHIP_CURVE_EVERY, FLAGSHIP_CURVE_EVAL = 2000, 256   # the eval curve
FLAGSHIP_COSINE = (0.0, 3e-4, 500, FLAGSHIP_STEPS, 1e-5)
FLAGSHIP_JAX = {"constant": 0.778, "cosine": 0.843}


def kernel_counters():
    """``(zero_counts, read_counts)``: set every kernel wrapper's launch
    count to 0, and read them all by name."""
    from graphnets_tpu_torch.ops.kernels import edge_update as eu
    from graphnets_tpu_torch.ops.kernels import edge_update_g1 as g1
    from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
    from graphnets_tpu_torch.ops.kernels import gather as ga
    from graphnets_tpu_torch.ops.kernels import ln_linear as ll
    from graphnets_tpu_torch.ops.kernels import random_gather as rg
    from graphnets_tpu_torch.ops.kernels import segment_sum as ss
    counters = {"edge_agg": (eu, "LAUNCHES"), "ffn": (ffn, "LAUNCHES"),
                "edge": (eu, "LAUNCHES_NO_AGG"),
                "segment_sum": (ss, "LAUNCHES"),
                "windowed": (ss, "WINDOWED_LAUNCHES"),
                "gather": (ga, "LAUNCHES"), "ln_backward": (ll, "LAUNCHES"),
                "ln_matmul": (ll, "FWD_LAUNCHES"),
                "gather_add": (ga, "ADD_LAUNCHES"),
                "edge_g1_agg": (g1, "LAUNCHES"),
                "edge_g1": (g1, "LAUNCHES_NO_AGG"),
                "ffn_backward": (ffn, "BWD_LAUNCHES"),
                "random_gather": (rg, "LAUNCHES")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    return zero_counts, read_counts


def headline_shard(torch, pt, i):
    """Data shard ``i`` of phase P: bench.py's 8 graphs from seed ``i`` in
    ``PadSpec.uniform(128, 2048)``, bf16, with 4b's random bf16 node and
    edge targets from seed ``1 + i`` (shard 0 is 4b's batch)."""
    bf = torch.bfloat16
    g = pt.batch(bench_graphs(i, N_PER_G, DEG, N_PER_G, N_PER_G * DEG),
                 pad=pt.PadSpec.uniform(N_PER_G, N_PER_G * DEG))
    g = g.with_features(ef=g.ef.to(bf), nf=g.nf.to(bf), gf=g.gf.to(bf))
    rng = np.random.default_rng(1 + i)
    target = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(device=g.device, dtype=bf)
    return g, g.with_features(ef=target(g.num_edge_slots, D),
                              nf=target(g.num_node_slots, D), gf=None)


def headline_cores(torch, pt, n):
    """``n`` headline GNCores at (384,)*3 from 4b's seeded generator."""
    gen = torch.Generator().manual_seed(0)
    return [pt.GNCore((D, D, D), generator=gen) for _ in range(n)]


def pipeline_loss(out):
    """``test_pipeline_gradient_equality``'s loss, in f32."""
    return sum(t.float().square().sum() for t in (out.ef, out.nf, out.gf))


def param_rule(torch, got, want, lr, what):
    """The captured-vs-eager rule on named parameters: each within 1e-5 of
    the reference's largest magnitude plus a tenth of ``lr``; returns the
    worst share of its bound and its name."""
    worst = (0.0, "")
    for n, q in want.items():
        q = q.detach()
        p = got[n].detach().to(q.device, q.dtype)
        if tuple(p.shape) != tuple(q.shape):
            raise SystemExit(f"{what}: {n} has shape {tuple(p.shape)}, "
                             f"expected {tuple(q.shape)}")
        if q.numel():
            bound = 1e-5 * float(q.abs().max()) + 0.1 * lr
            worst = max(worst, (float((p - q).abs().max()) / bound, n))
    return worst


def dp_captured_phase(torch, pt, mesh, expect, zero_counts, read_counts):
    """P(a): ``make_dp_train_step`` at world size 1 (NCCL) through
    ``capture_step``, the all-reduce inside the graph, against 4b's plain
    captured ``make_train_step`` on the same batch and weights."""
    from graphnets_tpu_torch.parallel import _comm
    from graphnets_tpu_torch.parallel.data_parallel import make_dp_train_step
    bf = torch.bfloat16
    g, y = headline_shard(torch, pt, 0)
    model_p = pt.GNCoreList(headline_cores(torch, pt, N_CORES))
    model_d = pt.GNCoreList(headline_cores(torch, pt, N_CORES))
    plain = pt.capture_step(pt.make_train_step(
        model_p, pt.adamw(model_p.parameters(), P_LR), compute_dtype=bf))
    dp = pt.capture_step(make_dp_train_step(
        model_d, pt.adamw(model_d.parameters(), P_LR), mesh,
        compute_dtype=bf))
    loss_p = float(plain(g, y)["loss"])
    zero_counts()
    before = _comm.COLLECTIVES
    loss_d = float(dp(g, y)["loss"])
    torch.cuda.synchronize()
    launches, collectives = read_counts(), _comm.COLLECTIVES - before
    # The calls through the step's body: two warm-ups and the capture.
    calls = dp.traced_calls
    want_counts(launches, {k: v * calls for k, v in expect.items()},
                "captured DP step")
    rel = abs(loss_d - loss_p) / abs(loss_p)
    worst = param_rule(torch, dict(model_d.named_parameters()),
                       dict(model_p.named_parameters()), P_LR, "P(a)")
    losses = [float(dp(g, y)["loss"]) for _ in range(10)]
    log(f"P(a) captured DP step (world size 1, NCCL): launches {launches}, "
        f"{collectives} all-reduces in {calls} calls through the "
        f"wrappers; loss {loss_d:.7f} vs the plain captured step "
        f"{loss_p:.7f} ({rel:.3e} relative, tolerance 1e-5); worst "
        f"parameter {worst[1]} at {worst[0]:.4f} of its bound (1e-5 x its "
        f"largest magnitude + 0.1 x lr); losses of 10 replays {losses}")
    if (rel > 1e-5 or worst[0] > 1.0 or collectives != calls
            or not all(np.isfinite(losses))):
        raise SystemExit("P(a): the captured DP step disagrees with the "
                         "plain captured step")
    times = {"plain": [], "dp": []}
    for which in ("plain", "dp", "dp", "plain"):
        fn = plain if which == "plain" else dp
        times[which].append(cuda_ms(torch, lambda: fn(g, y), iters=10))
    rows, busy, _ = profile_forward(torch, lambda: dp(g, y))
    nccl = [r for r in rows if "nccl" in r[2].lower()]
    plain_prof = profile_replay(torch, lambda: plain(g, y))
    return {"launches": launches, "collectives": collectives,
            "loss": loss_d, "plain_loss": loss_p, "loss_rel": rel,
            "worst_param": worst, "replay_losses": losses,
            "captured_ms": times["dp"], "plain_captured_ms": times["plain"],
            "replay_busy_ms": busy or None,
            "replay_kernels": sum(r[1] for r in rows),
            "plain_replay_busy_ms": plain_prof["replay_busy_ms"],
            "plain_replay_kernels": plain_prof["replay_kernels"],
            "nccl_kernels": [(r[0], r[1], r[2][:60]) for r in nccl]}


def parallel_ranks(rank, world):
    """One of the two ranks of P(b) and P(c), on ``cuda:0`` over gloo (the
    parent built the kernels): a DP step at (data, model) = (2, 1) on
    shard ``rank``, a DP x TP step at (1, 2) on shard 0 (default
    ``min_size``), and the S = 2 pipeline over ``P_MICROS`` microbatches.
    Returns the losses, parameters or gradients, launch counts and
    collective counts."""
    import torch
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.parallel import _comm
    from graphnets_tpu_torch.parallel.data_parallel import (
        make_dp_train_step, stack_shards)
    from graphnets_tpu_torch.parallel.mesh import make_mesh
    from graphnets_tpu_torch.parallel.pipeline import PipelinedCoreList
    from graphnets_tpu_torch.parallel.tensor_parallel import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    zero_counts, read_counts = kernel_counters()
    pt.enable_kernels(True)
    bf, host = torch.bfloat16, lambda t: t.detach().cpu()
    out = {}

    def counted(fn):
        zero_counts()
        c0, s0 = _comm.COLLECTIVES, _comm.HOST_STAGED
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, {"launches": read_counts(),
                        "collectives": _comm.COLLECTIVES - c0,
                        "host_staged": _comm.HOST_STAGED - s0,
                        "s": time.perf_counter() - t0}

    for name, sizes, shard in (("dp", (2, 1), rank), ("tp", (1, 2), 0)):
        mesh = make_mesh(sizes, ("data", "model"))
        g, y = headline_shard(torch, pt, shard)
        model = pt.GNCoreList(headline_cores(torch, pt, N_CORES))
        full = sum(p.numel() for p in model.parameters())
        if name == "tp":
            shard_params(model, mesh, "model")
        opt = pt.adamw(model.parameters(), P_LR)
        step = make_dp_train_step(model, opt, mesh, compute_dtype=bf,
                                  param_shardings=name == "tp")
        m, info = counted(lambda: step(g, y))
        out[name] = dict(info, loss=float(m["loss"]),
                         params={n: host(p)
                                 for n, p in model.named_parameters()},
                         dims=(dict(model.tensor_parallel.dims)
                               if name == "tp" else {}),
                         stored=sum(p.numel() for p in model.parameters()),
                         moments=sum(v.numel() for st in opt.state.values()
                                     for k, v in st.items()
                                     if k in ("exp_avg", "exp_avg_sq")),
                         replicated=full)
    mesh = make_mesh((2,), ("pipe",))
    pipe = PipelinedCoreList(headline_cores(torch, pt, P_STAGE_CORES), 2)
    micros = stack_shards([headline_shard(torch, pt, i)[0]
                           for i in range(P_MICROS)])

    def run():
        o = pipe(micros, mesh)
        pipeline_loss(o).backward()
        return o

    o, info = counted(run)
    sid = mesh.get_local_rank("pipe")
    out["pipe"] = dict(info, stage=sid, grads={
        n: host(p.grad) for n, p in pipe.stages[sid].named_parameters()},
        outputs=[host(t) for t in (o.ef, o.nf, o.gf)] if rank == 0 else None)
    return out


def parallel_phase(torch, pt, expect, zero_counts, read_counts, where):
    """Phase P: (a) the captured DP step at world size 1 (NCCL); (b) DP and
    DP x TP over two processes sharing the card (gloo) against one process
    over the same shards; (c) the S = 2 pipeline over the same two
    processes against the sequential stack; (d) the learning-rate schedule
    under capture.  Raises ``SystemExit`` on any miss."""
    import os
    import tempfile
    import torch.distributed as dist
    from torch.func import functional_call
    from graphnets_tpu_torch.parallel.distributed import init_distributed
    from graphnets_tpu_torch.parallel.launch import run_ranks
    from graphnets_tpu_torch.parallel.mesh import make_mesh
    from graphnets_tpu_torch.parallel.pipeline import PipelinedCoreList
    from graphnets_tpu_torch.params import shard_of
    from torch.distributed.tensor import Shard
    t_p = time.perf_counter()
    pt.enable_kernels(True)
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_p_")
    init_distributed(f"file://{os.path.join(work, 'store')}", 1, 0,
                     device="cuda", timeout_s=P_TIMEOUT_S)
    try:
        if dist.get_backend() != "nccl":
            raise SystemExit(f"P(a): backend {dist.get_backend()}, not nccl")
        out["a"] = dp_captured_phase(torch, pt, make_mesh(), expect,
                                     zero_counts, read_counts)
    finally:
        dist.destroy_process_group()
    a = out["a"]
    log(f"P(a) captured DP step {a['captured_ms']} ms against the plain "
        f"captured step {a['plain_captured_ms']} ms (turns: plain, DP, DP, "
        f"plain); one profiled replay {a['replay_kernels']} kernels of "
        f"{a['replay_busy_ms'] or 0:.4f} ms, busy share "
        f"{busy_share(a['replay_busy_ms'], a['captured_ms'][0])} (the plain "
        f"step's: {a['plain_replay_kernels']} of "
        f"{a['plain_replay_busy_ms'] or 0:.4f} ms, "
        f"{busy_share(a['plain_replay_busy_ms'], a['plain_captured_ms'][0])}"
        f"; the DP step returns the loss alone, without the accuracies); NCCL "
        f"kernels in the replay {a['nccl_kernels']}; {where}")

    # (b) and (c): two ranks on cuda:0 over gloo.
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_ranks, 2, os.path.join(work, "ranks"),
                      device="cuda", backend="gloo", timeout_s=P_TIMEOUT_S,
                      threads=4)
    spawn_s = time.perf_counter() - t0
    bf = torch.bfloat16
    for r, got in enumerate(ranks):
        for k in ("dp", "tp", "pipe"):
            log(f"P rank {r} {k}: launches {got[k]['launches']}, "
                f"{got[k]['collectives']} collectives, "
                f"{got[k]['host_staged']} of them staged through the host "
                f"(gloo takes no CUDA tensor for them), {got[k]['s']:.3f} s")

    # (b) DP: one process over the same two shards, the mean loss.
    shards = [headline_shard(torch, pt, i) for i in range(2)]
    model = pt.GNCoreList(headline_cores(torch, pt, N_CORES))
    params = dict(model.named_parameters())
    run = {n: p.to(bf) for n, p in params.items()}
    loss = sum(pt.graph_loss_nf_ef(functional_call(
        model, run, (x,), {"training": True}), y) for x, y in shards) / 2
    loss.backward()
    pt.adamw(model.parameters(), P_LR).step()
    ref_loss = float(loss.detach())
    for r, got in enumerate(ranks):
        rel = abs(got["dp"]["loss"] - ref_loss) / abs(ref_loss)
        worst = param_rule(torch, got["dp"]["params"], params, P_LR, "P(b)")
        log(f"P(b) DP (2, 1) rank {r}: loss {got['dp']['loss']:.7f} vs one "
            f"process over both shards {ref_loss:.7f} ({rel:.3e} relative, "
            f"tolerance 1e-4); worst parameter {worst[1]} at "
            f"{worst[0]:.4f} of its bound")
        if rel > 1e-4 or worst[0] > 1.0:
            raise SystemExit(f"P(b): DP rank {r} disagrees with one process")
    # (b) DP x TP: one process on shard 0.
    model = pt.GNCoreList(headline_cores(torch, pt, N_CORES))
    m = pt.make_train_step(model, pt.adamw(model.parameters(), P_LR),
                           compute_dtype=bf)(*shards[0])
    ref_loss = float(m["loss"])
    full = {n: p.detach() for n, p in model.named_parameters()}
    for r, got in enumerate(ranks):
        tp = got["tp"]
        want = {n: shard_of(p, Shard(tp["dims"][n]), r, 2)
                if n in tp["dims"] else p for n, p in full.items()}
        rel = abs(tp["loss"] - ref_loss) / abs(ref_loss)
        worst = param_rule(torch, tp["params"], want, P_LR, "P(b) TP")
        log(f"P(b) DP x TP (1, 2) rank {r}: loss {tp['loss']:.7f} vs one "
            f"process {ref_loss:.7f} ({rel:.3e} relative, tolerance 1e-4); "
            f"worst parameter {worst[1]} at {worst[0]:.4f} of its bound; "
            f"{len(tp['dims'])} of {len(full)} weights sharded; stored "
            f"{tp['stored']} parameter and {tp['moments']} moment elements "
            f"against {tp['replicated']} and {2 * tp['replicated']} "
            f"replicated")
        if (rel > 1e-4 or worst[0] > 1.0 or not tp["dims"]
                or tp["stored"] >= tp["replicated"]
                or tp["moments"] != 2 * tp["stored"]):
            raise SystemExit(f"P(b): DP x TP rank {r} disagrees with one "
                             "process")

    # (c) The pipeline against the sequential stack in this process, on
    # the kernel route, then against the plain route under 4b's rule.
    micros = [headline_shard(torch, pt, i)[0] for i in range(P_MICROS)]

    def sequential(dtype=None):
        pipe = PipelinedCoreList(headline_cores(torch, pt, P_STAGE_CORES), 2)
        seq = pipe.sequential()
        outs = []
        for g in micros:
            if dtype is not None:
                g = g.with_features(ef=g.ef.to(dtype), nf=g.nf.to(dtype),
                                    gf=g.gf.to(dtype))
            outs.append(seq(g))
        sum(pipeline_loss(o) for o in outs).backward()
        return outs, [{n: p.grad for n, p in st.named_parameters()}
                      for st in pipe.stages]

    zero_counts()
    outs, grads = sequential()
    torch.cuda.synchronize()
    seq_launches = read_counts()
    pipe_launches = {k: sum(got["pipe"]["launches"][k] for got in ranks)
                     for k in seq_launches}
    if pipe_launches != seq_launches or not all(
            pipe_launches[k] for k in ("edge_agg", "ffn", "gather",
                                       "ln_backward", "segment_sum",
                                       "windowed")):
        raise SystemExit(f"P(c): the pipeline's launches {pipe_launches} "
                         f"are not the sequential stack's {seq_launches}")
    worst_out = 0.0
    for i, name in enumerate(("ef", "nf", "gf")):
        for mi, o in enumerate(outs):
            ref = getattr(o, name).float()
            got = ranks[0]["pipe"]["outputs"][i][mi].to(ref.device).float()
            worst_out = max(worst_out, float((got - ref).abs().max())
                            / (1e-5 * float(ref.abs().max())))
    worst_seq = (0.0, "")
    for got in ranks:
        s = got["pipe"]["stage"]
        for n, q in grads[s].items():
            p = got["pipe"]["grads"][n].to(q.device)
            worst_seq = max(worst_seq, (float((p - q).abs().max())
                                        / (1e-5 * float(q.abs().max())),
                                        f"stage {s} {n}"))
    pt.enable_kernels(False)
    _, plain = sequential()
    _, plain32 = sequential(torch.float32)
    pt.enable_kernels(True)
    worst_plain = (0.0, "")
    for got in ranks:
        s = got["pipe"]["stage"]
        for n, q in plain[s].items():
            p = got["pipe"]["grads"][n].to(q.device)
            bound = max(5e-2 * float(q.abs().max()),
                        float((q - plain32[s][n]).abs().max()))
            worst_plain = max(worst_plain, (float((p - q).abs().max())
                                            / bound, f"stage {s} {n}"))
    log(f"P(c) pipeline S = 2, M = {P_MICROS}, {P_STAGE_CORES} headline "
        f"cores: launches (both ranks) {pipe_launches}, the sequential "
        f"stack's {seq_launches}; outputs at {worst_out:.4f} and worst "
        f"gradient {worst_seq[1]} at {worst_seq[0]:.4f} of 1e-5 of their "
        f"largest magnitudes from the sequential stack's; against the "
        f"plain route under 4b's rule worst {worst_plain[1]} at "
        f"{worst_plain[0]:.4f} of its bound; loss through the ranks "
        f"{ranks[0]['pipe']['s']:.3f} / {ranks[1]['pipe']['s']:.3f} s")
    if worst_out > 1.0 or worst_seq[0] > 1.0 or worst_plain[0] > 1.0:
        raise SystemExit("P(c): the pipeline disagrees")
    out["d"] = schedule_phase(torch, pt)
    out.update(spawn_s=spawn_s, launches={
        "dp_train_step": out["a"]["launches"],
        "dp_tp_train_step": ranks[0]["tp"]["launches"],
        "pipeline": pipe_launches})
    out["ranks"] = [{k: {kk: v for kk, v in got[k].items()
                         if kk not in ("params", "grads", "outputs")}
                     for k in got} for got in ranks]
    log(f"phase P took {time.perf_counter() - t_p:.1f} s (the two ranks "
        f"{spawn_s:.1f} s of it, their start included); {where}")
    return out


def optax_warmup_cosine(count, init, peak, warmup, decay, end):
    """optax's ``warmup_cosine_decay_schedule`` at ``count``, evaluated in
    numpy f32 term by term."""
    f = np.float32
    if count < warmup:
        frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
        return f(init - peak) * frac + f(peak)
    steps = f(decay - warmup)
    c = min(f(count - warmup), steps)
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / steps))
    alpha = end / peak
    return f(peak) * (f(1 - alpha) * cosine + f(alpha))


def schedule_phase(torch, pt):
    """P(d): the flagship's warmup-cosine schedule on the card: its values
    against optax's formula in numpy (2 f32 ulps), a captured chunk of the
    device loop's step against its eager twin (the rate written at each
    step bit-equal and equal to the schedule at the step's count, the
    parameters under the captured-vs-eager rule) and ``train_sort_device``
    itself with it."""
    from graphnets_tpu_torch.training.schedules import \
        warmup_cosine_decay_schedule
    dev = torch.device("cuda")
    sched = warmup_cosine_decay_schedule(*FLAGSHIP_COSINE)
    ulps = {}
    for c in (0, 499, 500, 19_999):
        got = np.float32(sched(torch.tensor(float(c), device=dev)).item())
        want = optax_warmup_cosine(c, *FLAGSHIP_COSINE)
        ulps[c] = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
    cfg = pt.SortTaskConfig()
    pad = pt.sort_pad_spec(cfg)

    def state():
        model = pt.EncodeProcessDecode(
            (0, cfg.vocab_size, 0), (D, D, D), (2, 2, 0), n_cores=2,
            generator=torch.Generator().manual_seed(0))
        return pt.TrainState(model, pt.adamw(model.parameters(), sched), 0,
                             (torch.Generator(device=dev).manual_seed(1),))

    rates = {}
    states = {}
    for how in ("captured", "eager"):
        st = states[how] = state()
        step = pt.make_sort_device_step(st, cfg, pad)
        run = pt.capture_step(step) if how == "captured" else step
        lr = st.optimizer.param_groups[0]["lr"]
        rates[how] = []
        for _ in range(8):
            run()
            rates[how].append(lr.item())
    want = [sched(torch.tensor(float(i), device=dev)).item()
            for i in range(8)]
    worst = param_rule(torch,
                       dict(states["captured"].model.named_parameters()),
                       dict(states["eager"].model.named_parameters()),
                       FLAGSHIP_COSINE[1], "P(d)")
    res = pt.train_sort_device(steps=S_CHUNK, cfg=cfg, core_dims=(D, D, D),
                               n_cores=2, learning_rate=sched, seed=0,
                               chunk=S_CHUNK)
    last = res.optimizer.param_groups[0]["lr"].item()
    log(f"P(d) schedule: ulps from optax's formula at 0 / 499 / 500 / "
        f"19999: {ulps}; the rates of 8 captured steps {rates['captured']} "
        f"(eager {rates['eager']}); worst parameter {worst[1]} at "
        f"{worst[0]:.4f} of its bound; train_sort_device {S_CHUNK} steps: "
        f"last rate {last} (schedule at {S_CHUNK - 1}: "
        f"{sched(torch.tensor(S_CHUNK - 1.0)).item()}), metrics "
        f"{res.metrics}")
    if (max(ulps.values()) > 2 or rates["captured"] != rates["eager"]
            or rates["captured"] != want or worst[0] > 1.0
            or last != sched(torch.tensor(S_CHUNK - 1.0, device=dev)).item()
            or not all(np.isfinite(list(res.metrics.values())))):
        raise SystemExit("P(d): the schedule disagrees")
    return {"ulps": ulps, "rates": rates["captured"], "worst_param": worst,
            "metrics": res.metrics}


def flagship_phase(torch, pt, seeds=None):
    """``--phase flagship``: the flagship recipe (``benchmarks/run_flagship.py``)
    on the card, f32: 20,000 steps of ``train_sort_device`` at a constant
    3e-4 and with the warmup-cosine schedule, each followed by
    ``evaluate_sort`` over 1024 batches, beside JAX's records.  Every 2,000
    steps the chunk's mean ``graph_acc`` and ``evaluate_sort``'s over 256
    batches (the same batches each time) are recorded, a curve that tells
    a run that ends on a bad step from one that stays below JAX's (the
    steps/s include these evaluations).  With ``seeds`` the constant
    recipe alone runs once a seed (model and batches from that seed), and
    the mean of their ``graph_acc`` is held to JAX's record."""
    from graphnets_tpu_torch.training.schedules import \
        warmup_cosine_decay_schedule
    cfg = pt.SortTaskConfig()
    out = {}
    runs = ([(f"constant_seed{s}", "constant", 3e-4, s) for s in seeds]
            if seeds else
            [("constant", "constant", 3e-4, 0),
             ("cosine", "cosine",
              warmup_cosine_decay_schedule(*FLAGSHIP_COSINE), 0)])
    for name, recipe, lr, seed in runs:
        # train_sort_device's own model for the seed, built here so that
        # the curve can evaluate it between chunks.
        model = pt.EncodeProcessDecode(
            (0, cfg.vocab_size, 0), (D, D, D), (2, 2, 0), n_cores=2,
            generator=torch.Generator().manual_seed(seed))
        curve = []

        def point(step, metrics):
            if step % FLAGSHIP_CURVE_EVERY == 0:
                ev = pt.evaluate_sort(model, cfg,
                                      n_batches=FLAGSHIP_CURVE_EVAL)
                curve.append((step, round(metrics["graph_acc"], 4),
                              round(ev["graph_acc"], 4)))

        t0 = time.perf_counter()
        res = pt.train_sort_device(steps=FLAGSHIP_STEPS, cfg=cfg,
                                   core_dims=(D, D, D), n_cores=2,
                                   learning_rate=lr, seed=seed, chunk=1000,
                                   model=model, log_fn=point)
        wall = time.perf_counter() - t0
        ev = pt.evaluate_sort(res.model, cfg, n_batches=FLAGSHIP_EVAL)
        out[name] = {"steps_per_sec": res.steps_per_sec, "wall_s": wall,
                     "train_metrics": res.metrics, "eval": ev,
                     "curve": curve, "jax_graph_acc": FLAGSHIP_JAX[recipe],
                     "fault": (not seeds and ev["graph_acc"]
                               < FLAGSHIP_JAX[recipe] - 0.05)}
        log(f"flagship {name}: {FLAGSHIP_STEPS} steps in {wall:.1f} s "
            f"({res.steps_per_sec:.2f} steps/s with the curve's "
            f"evaluations), last chunk {res.metrics}; evaluate_sort over "
            f"{FLAGSHIP_EVAL} batches {ev}; JAX's record graph_acc "
            f"{FLAGSHIP_JAX[recipe]}; (step, chunk graph_acc, eval graph_acc "
            f"over {FLAGSHIP_CURVE_EVAL} batches) {curve}")
    if seeds:
        mean = float(np.mean([out[n]["eval"]["graph_acc"] for n in out]))
        fault = mean < FLAGSHIP_JAX["constant"] - 0.05
        out["mean"] = {"graph_acc": mean, "seeds": list(seeds),
                       "jax_graph_acc": FLAGSHIP_JAX["constant"],
                       "fault": fault}
        log(f"flagship constant over seeds {list(seeds)}: mean eval "
            f"graph_acc {mean:.4f} against JAX's {FLAGSHIP_JAX['constant']}"
            f" (a fault below {FLAGSHIP_JAX['constant'] - 0.05:.3f})")
    return out


# The GNCore training gates re-measured by ``--phase gates``: JAX's settings
# (the port's constants) and one change each.
GATE_SETTINGS = (
    ("jax", {}),
    ("max_dim_384", {"max_dim": 384}),
    ("min_rows_8192", {"min_rows": 8192}),
    ("agg_off", {"agg": False}),
)


def adamw_phase(torch, pt, where):
    """``--phase adamw`` (see the module's docstring): a row a parameter
    set with the values, the bound, each variant's ms a step (two
    readings, in the order kernel, plain, lib, lib, plain, kernel), its
    kernels a step, the kernel's launches in one step, and the kernel's
    largest error in ulps at each checked setting."""
    from graphnets_tpu_torch.ops.kernels import adamw as ak
    from graphnets_tpu_torch.training.optim import FusedAdamW
    models = {
        "sort": lambda: pt.EncodeProcessDecode(
            (0, 100, 0), (384,) * 3, (2, 2, 0), n_cores=2, device="cuda"),
        "lg256": lambda: pt.GNCoreList(
            [pt.GNCore((256,) * 3, device="cuda") for _ in range(3)])}

    def make(variant, ps, lr, wd):
        hyper = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
                     capturable=True)
        if variant == "kernel":
            return FusedAdamW(ps, **hyper)
        return torch.optim.AdamW(ps, **hyper, **(
            {"foreach": True} if variant == "plain" else {"fused": True}))

    def fresh(base, grads):
        ps = [torch.nn.Parameter(p.clone()) for p in base]
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        return ps

    # The benchmark's setting, and one where the decay moves each value by
    # 1e-3 of itself a step, far above the tolerance, so that a kernel
    # without it fails.
    checks = {"lr3e-4_wd1e-4": (3e-4, 1e-4), "lr1e-2_wd1e-1": (1e-2, 0.1)}
    out = {}
    for name, build in models.items():
        base = [p.detach() for p in build().parameters()]
        gen = torch.Generator(device="cuda").manual_seed(0)
        grads = [torch.randn(p.shape, generator=gen, device="cuda")
                 for p in base]
        numel = sum(p.numel() for p in base)
        row = {"tensors": len(base), "values": numel,
               "bound_ms": 28 * numel / H100_BYTES_PER_S * 1e3,
               "ms": {v: [] for v in ("kernel", "plain", "lib")},
               "kernels_per_step": {}, "worst_ulps": {}}
        # Ten eager steps of the kernel against the plain version.
        for setting, (lr, wd) in checks.items():
            (kopt, kps), (popt, pps) = [
                (make(v, ps, lr, wd), ps)
                for v, ps in (("kernel", fresh(base, grads)),
                              ("plain", fresh(base, grads)))]
            for _ in range(10):
                kopt.step()
                popt.step()
            torch.cuda.synchronize()
            worst = 0.0
            for p, q in zip(kps, pps):
                pairs = [(p.detach(), q.detach())] + [
                    (kopt.state[p][k], popt.state[q][k])
                    for k in ("exp_avg", "exp_avg_sq")]
                for a, b in pairs:
                    if b.numel():
                        scale = float(b.abs().max()) * 2.0 ** -23
                        worst = max(worst, float((a - b).abs().max())
                                    / max(scale, 1e-45))
                if float(kopt.state[p]["step"]) != 10:
                    raise SystemExit(f"adamw {name}: step counts not "
                                     f"advanced")
            row["worst_ulps"][setting] = worst
            if worst > 4:
                raise SystemExit(f"adamw {name} {setting}: the kernel "
                                 f"disagrees with torch's foreach AdamW "
                                 f"({worst:.2f} ulps)")
        opts = {v: make(v, fresh(base, grads), 3e-4, 1e-4)
                for v in row["ms"]}
        for v in ("kernel", "plain", "lib", "lib", "plain", "kernel"):
            row["ms"][v].append(graph_ms(torch, opts[v].step))
        for v, opt in opts.items():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                opt.step()
            row["kernels_per_step"][v] = profile_replay(
                torch, graph.replay)["replay_kernels"]
        ak.LAUNCHES = 0
        opts["kernel"].step()
        row["launches_per_step"] = ak.LAUNCHES
        log(f"adamw {name}: {len(base)} tensors, {numel:,} values, bound "
            f"{row['bound_ms']:.4f} ms; ms a step as graph replays: kernel "
            f"{row['ms']['kernel']}, plain (foreach) {row['ms']['plain']}, "
            f"lib (fused) {row['ms']['lib']}; kernels a step "
            f"{row['kernels_per_step']}, kernel launches a step "
            f"{row['launches_per_step']}; kernel against plain after 10 "
            f"steps {row['worst_ulps']} ulps (tolerance 4); {where}")
        out[name] = row
    return out


def split_phase(torch, pt, logs, where):
    """``--phase split`` (see the module's docstring): a row an edge set
    with its shape, the errors against the plain version, and the forward
    and backward times (kernel, plain, composed) beside their bounds."""
    import torch.nn.functional as F
    from graphnets_tpu_torch.ops.kernels import split_edge_layer as sel
    from graphnets_tpu_torch.ops.scatter import gather_nodes

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    def ulps(a, b):
        return int((key(a) - key(b)).abs().max())

    def ulp_err(a, b):
        # In ulps of b's values, an ulp no smaller than 2^-16 of b's
        # largest magnitude (a sum that cancels to near 0 moves by ~1e-6
        # of its terms with the f32 adds' order).
        a, b = a.float(), b.float()
        ulp = torch.ldexp(torch.ones_like(b), torch.frexp(b.abs())[1] - 8)
        ulp = torch.where(b == 0, 0.0, ulp)
        ulp = torch.maximum(ulp, 2.0 ** -16 * b.abs().max())
        return float(((a - b).abs() / ulp).max())

    report = [line.strip() for line in logs.get("split_edge_layer",
                                                "").splitlines()
              if "registers" in line or "spill" in line]
    log(f"split_edge_layer ptxas: {report}")
    tg = pt.batch_samples(pt.build_graphcast_graph(1.0, 5, 0.6), 4,
                          device="cuda")
    ends = {"mesh": ("mesh", "mesh"), "g2m": ("grid", "mesh"),
            "m2g": ("mesh", "grid")}
    D = H = 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (src, dst) in ends.items():
        es = tg.edges[name]
        E, n_s, n_r = es.senders.shape[0], tg.num_nodes(src), tg.num_nodes(dst)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")
                    ).to(torch.bfloat16)
        x = dict(e=rand(E, D), w_e=rand(D, H, scale=D ** -0.5),
                 p_s=rand(n_s, H), p_r=rand(n_r, H), b=rand(H),
                 senders=es.senders, receivers=es.receivers)
        d_h = rand(E, H)
        pre, h = sel._forward_kernel(**x)
        ppre, _ = sel.split_edge_layer_plain(**x)
        d_pre, d_b = sel._backward_kernel(d_h, pre.clone())
        p_dpre, _ = sel.split_edge_backward_plain(d_h, pre)
        torch.cuda.synchronize()
        scale = d_pre.double().abs().sum(0)
        row = {"rows": E, "sender_rows": n_s, "receiver_rows": n_r,
               "pre_ulps": ulp_err(pre, ppre),
               "h_ulps": ulp_err(h, F.silu(pre.float()).to(torch.bfloat16)),
               "d_pre_ulps": ulps(d_pre, p_dpre),
               "d_b_err": float(((d_b.double() - d_pre.double().sum(0)).abs()
                                 / scale).max())}
        row["ok"] = (row["pre_ulps"] <= 1 and row["h_ulps"] <= 1
                     and row["d_pre_ulps"] <= 1 and row["d_b_err"] <= 1e-5)

        def composed():
            p = (x["e"] @ x["w_e"] + gather_nodes(x["p_s"], x["senders"])
                 + gather_nodes(x["p_r"], x["receivers"], idx_sorted=True)
                 + x["b"])
            return F.silu(p)

        def composed_bwd():
            dp = torch.ops.aten.silu_backward(d_h, pre)
            return dp, dp.sum(0)
        ms = lambda fn: cuda_ms(torch, fn, iters=10, warmup=2)
        fwd_bytes = 2 * (E * D + n_s * H + n_r * H + H + D * H
                         + 2 * E * H) + 8 * E
        bwd_bytes = 2 * 3 * E * H + 4 * H
        fb, fby = bound_ms(fwd_bytes, 2 * E * D * H)
        bb, bby = bound_ms(bwd_bytes, 0)
        row["forward"] = {
            "kernel_ms": [ms(lambda: sel._forward_kernel(**x))],
            "plain_ms": ms(lambda: sel.split_edge_layer_plain(**x)),
            "composed_ms": ms(composed), "bound_ms": fb, "bound_by": fby}
        # The kernel writes d_pre over its second argument: a scratch copy.
        scratch = pre.clone()
        row["backward"] = {
            "kernel_ms": [ms(lambda: sel._backward_kernel(d_h, scratch))],
            "plain_ms": ms(lambda: sel.split_edge_backward_plain(d_h, pre)),
            "composed_ms": ms(composed_bwd), "bound_ms": bb, "bound_by": bby}
        row["forward"]["kernel_ms"].append(
            ms(lambda: sel._forward_kernel(**x)))
        row["backward"]["kernel_ms"].append(
            ms(lambda: sel._backward_kernel(d_h, scratch)))
        log(f"split {name} [{E}, {D}] -> {H}, tables {n_s} / {n_r}: "
            f"forward {row['forward']}, backward {row['backward']}; "
            f"against plain: pre {row['pre_ulps']} ulps, h "
            f"{row['h_ulps']}, d_pre {row['d_pre_ulps']}, d_b "
            f"{row['d_b_err']:.2e}; {where}")
        out[name] = row
        del x, d_h, pre, h, ppre, d_pre, p_dpre, scratch
        torch.cuda.empty_cache()
    return out


def gates_phase(torch, pt):
    """``python3 chip_smoke.py --phase gates``: the phase C train step (the large
    graph, d = 256) and the phase D sampled step under JAX's training gates
    and under one change each: ``_FUSED_FFN_TRAIN_MAX_DIM`` 384,
    ``_FUSED_FFN_TRAIN_MIN_ROWS`` 8,192 (D's 56,320 / 56,960-row sets then
    train fused) and ``g1_agg_fusion_training`` off.  Each setting runs
    twice, the second pass in reverse order; a time is the mean of a few
    steps between CUDA events after one warm-up step, with the summed
    kernel time of one profiled step (the sampled step is host-bound, so
    its eager times spread) and the FFN forward / backward launches of one
    step beside it."""
    from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
    from graphnets_tpu_torch.utils.config import get_config
    cfg = get_config()
    base = (pt.GNCore._FUSED_FFN_TRAIN_MAX_DIM,
            pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS, cfg.g1_agg_fusion_training)

    def apply(st):
        pt.GNCore._FUSED_FFN_TRAIN_MAX_DIM = st.get("max_dim", base[0])
        pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS = st.get("min_rows", base[1])
        cfg.g1_agg_fusion_training = st.get("agg", base[2])

    pt.enable_kernels(True)
    g = large_graph(torch, pt)
    rng = np.random.default_rng(1)
    target = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(device=g.device, dtype=torch.bfloat16)
    y = g.with_features(ef=target(LG_E, LG_D), nf=target(LG_N, LG_D),
                        gf=None)
    model_c = pt.GNCoreList([pt.GNCore((LG_D,) * 3,
                                       generator=torch.Generator()
                                       .manual_seed(0))
                             for _ in range(LG_CORES)])
    step_c = pt.make_train_step(model_c, pt.adamw(model_c.parameters(), 3e-4),
                                compute_dtype=torch.bfloat16)
    graph = arxiv_shaped_graph(pt)
    sampler = pt.NeighborSampler(graph, fanouts=AX_FANOUTS,
                                 batch_size=AX_BATCH, seed=1,
                                 emit_node_ids=True)
    feat = pt.device_feature_table(graph, torch.bfloat16)
    model_d = pt.EncodeProcessDecode(
        (0, AX_FEAT, 0), (AX_HIDDEN,) * 3, (1, AX_CLASSES, 0),
        n_cores=AX_CORES, generator=torch.Generator().manual_seed(0))
    step_d = pt.make_node_classification_step(
        model_d, torch.optim.Adam(model_d.parameters(), lr=1e-3),
        AX_CLASSES, compute_dtype=torch.bfloat16)
    b = next(sampler.epoch(np.arange(graph.num_nodes)))
    run_d = lambda: step_d(b.graph, b.node_ids, b.labels, b.label_mask,
                           b.seed_local_idx, feat)
    results = {}
    order = list(GATE_SETTINGS) + list(reversed(GATE_SETTINGS))
    try:
        for name, st in order:
            apply(st)
            row = {}
            for key, fn, iters in (("c", lambda: step_c(g, y), 3),
                                   ("d", run_d, 10)):
                fn()
                torch.cuda.synchronize()
                before = (ffn.LAUNCHES, ffn.BWD_LAUNCHES)
                fn()
                torch.cuda.synchronize()
                row[key + "_ffn"] = (ffn.LAUNCHES - before[0],
                                     ffn.BWD_LAUNCHES - before[1])
                row[key + "_ms"] = cuda_ms(torch, fn, iters=iters, warmup=0)
                row[key + "_device_ms"] = profile_forward(torch, fn)[1]
            results.setdefault(name, []).append(row)
            log(f"gates {name}: C step {row['c_ms']:.4f} ms eager, "
                f"{row['c_device_ms']:.4f} ms of kernels (FFN fwd/bwd "
                f"launches {row['c_ffn']}); D step {row['d_ms']:.4f} ms "
                f"eager, {row['d_device_ms']:.4f} ms of kernels "
                f"({row['d_ffn']})")
    finally:
        apply({})
    return results


# Phase G: edge-partitioned graph parallelism.  The large graph of
# benchmarks/bench_partitioned.py --large (build_single_graph, seed 0; C's
# size and width) and, for the blocks and the partitioners, a smaller
# graph at the headline width.
G_N, G_DEG, G_D, G_CORES, G_LR = 65536, 16, 256, 3, 3e-4
G_SMALL_N, G_SMALL_DEG, G_SMALL_WINDOW = 1024, 16, 32
G_TIMEOUT_S = 600


def partitioned_arrays(seed=0, N=G_N, deg=G_DEG, d=G_D):
    """``benchmarks/bench_partitioned.py``'s ``build_single_graph(seed)``:
    receivers ascending with in-degree ``deg``, each node's senders drawn
    without replacement, normal f32 features; and its targets (normal,
    from seed 1)."""
    rng = np.random.default_rng(seed)
    E = N * deg
    receivers = np.repeat(np.arange(N), deg)
    senders = np.concatenate([rng.choice(N, size=deg, replace=False)
                              for _ in range(N)])
    ef = rng.normal(size=(E, d)).astype(np.float32)
    nf = rng.normal(size=(N, d)).astype(np.float32)
    gf = rng.normal(size=(d,)).astype(np.float32)
    rng = np.random.default_rng(1)
    y_ef = rng.normal(size=(E, d)).astype(np.float32)
    y_nf = rng.normal(size=(N, d)).astype(np.float32)
    return {"senders": senders.astype(np.int64),
            "receivers": receivers.astype(np.int64), "ef": ef, "nf": nf,
            "gf": gf, "y_ef": y_ef, "y_nf": y_nf}


def local_arrays(seed=2, N=G_SMALL_N, deg=G_SMALL_DEG, d=D,
                 window=G_SMALL_WINDOW):
    """The smaller graph of G(c) and G(d): each node receives from ``deg``
    nodes within ``window`` places of it on a ring, and the node ids are
    scrambled, so contiguous blocks of the ids cut about half the edges
    and an order that finds the ring cuts few; normal f32 features at the
    headline width."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([np.arange(-window, 0),
                              np.arange(1, window + 1)])
    receivers = np.repeat(np.arange(N), deg)
    senders = np.concatenate([(v + rng.choice(offsets, size=deg,
                                              replace=False)) % N
                              for v in range(N)])
    perm = rng.permutation(N)
    E = N * deg
    return {"senders": perm[senders].astype(np.int64),
            "receivers": perm[receivers].astype(np.int64),
            "ef": rng.normal(size=(E, d)).astype(np.float32),
            "nf": rng.normal(size=(N, d)).astype(np.float32),
            "gf": rng.normal(size=(d,)).astype(np.float32)}


def whole_graph(torch, pt, a, dtype, device="cuda"):
    """The arrays as one unpartitioned ``GraphsTuple`` in canonical order
    (receivers ascending, stably) and that order."""
    order = np.argsort(a["receivers"], kind="stable")
    N, E = a["nf"].shape[0], a["senders"].shape[0]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    g = pt.GraphsTuple(
        senders=t(a["senders"][order].astype(np.int32)),
        receivers=t(a["receivers"][order].astype(np.int32)),
        node_graph=torch.zeros(N, **i32), edge_graph=torch.zeros(E, **i32),
        n_node=torch.tensor([N], **i32), n_edge=torch.tensor([E], **i32),
        node_mask=torch.ones(N, dtype=torch.bool, device=device),
        edge_mask=torch.ones(E, dtype=torch.bool, device=device),
        graph_mask=torch.ones(1, dtype=torch.bool, device=device),
        ef=t(a["ef"][order]).to(dtype), nf=t(a["nf"]).to(dtype),
        gf=t(a["gf"])[None].to(dtype))
    return g, order


def g_cores(torch, pt):
    """Phase C's stack: 3 GNCores at (256,)*3 from the seeded generator,
    f32 masters."""
    gen = torch.Generator().manual_seed(0)
    return pt.GNCoreList([pt.GNCore((G_D,) * 3, generator=gen)
                          for _ in range(G_CORES)])


def local_shard(torch, ep, a, S, rank, targets=True):
    """Rank ``rank``'s shard of the arrays' S-way partition on the card,
    f32 (no host metadata, so it captures), the halo plan's slice, the
    targets' slices, the host partition (for ``edge_index``) and the
    plan's build time."""
    pg = ep.partition_edges(a["senders"], a["receivers"], a["nf"], S,
                            ef=a["ef"], gf=a["gf"], device="cpu")
    t0 = time.perf_counter()
    plan = ep.build_halo_plan(pg)
    plan_s = time.perf_counter() - t0
    lg = pg.shard(rank, "cuda").replace(edge_index=None)
    ys = None
    if targets:
        py = ep.partition_edges(a["senders"], a["receivers"], a["y_nf"], S,
                                ef=a["y_ef"], device="cpu")
        ys = (py.nf[rank:rank + 1].to("cuda"), py.ef[rank:rank + 1].to("cuda"))
    return lg, plan.shard(rank, "cuda"), ys, pg, plan_s


def as_dtype(lg, dtype):
    """A partitioned slice's features in ``dtype``."""
    return lg.replace(ef=lg.ef.to(dtype), nf=lg.nf.to(dtype),
                      gf=lg.gf.to(dtype))


def reordered_arrays(a, seed=5):
    """The arrays with each node's in-edges in another order (receivers
    ascend with in-degree ``G_DEG``, so a permutation within each row of
    ``[N, G_DEG]``): the same graph, other f32 summation orders."""
    E = a["senders"].shape[0]
    perm = np.random.default_rng(seed).permuted(
        np.arange(E).reshape(-1, G_DEG), axis=1).reshape(-1)
    return dict(a, senders=a["senders"][perm], ef=a["ef"][perm],
                y_ef=a["y_ef"][perm])


def partitioned_steps(torch, pt, eps, plan, mesh, lg, ys, route_matched,
                      names=("bf16", "f32")):
    """One eager partitioned train step of phase C's stack in bf16 (f32
    masters) and one in f32 (those of ``names``), from the seeded weights:
    the losses, the gradients (summed over the axis) and the parameters
    after each (on the host).  ``route_matched`` raises the
    fused FFN's training row gate above the whole graph's node count, so
    the node set composes as a 32,768-row shard's does."""
    bf = torch.bfloat16
    saved = pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS
    if route_matched:
        pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS = max(saved, G_N + 1)
    out = {}
    try:
        for name, dtype, compute in (("bf16", bf, bf),
                                     ("f32", torch.float32, None)):
            if name not in names:
                continue
            m = g_cores(torch, pt)
            step = eps.make_partitioned_core_list_train_step(
                m, pt.adamw(m.parameters(), G_LR), plan, mesh,
                compute_dtype=compute)
            loss = float(step(as_dtype(lg, dtype), ys[0].to(dtype),
                              ys[1].to(dtype))["loss"])
            out[name] = {"loss": loss,
                         "params": {n: p.detach().cpu()
                                    for n, p in m.named_parameters()},
                         "grads": {n: p.grad.detach().cpu()
                                   for n, p in m.named_parameters()}}
            del m, step
    finally:
        pt.GNCore._FUSED_FFN_TRAIN_MIN_ROWS = saved
    return out


def feature_errors(got, ref):
    """Largest error of each feature set over its reference's largest
    magnitude (the forward rule of PERF.md section 2: 5e-2)."""
    return {k: float((a.float() - r.float()).abs().max()
                     / r.float().abs().max().clamp(min=1e-30))
            for k, a, r in zip(("ef", "nf", "gf"), got, ref)}


def partitioned_s1(torch, pt, zero_counts, read_counts, where):
    """G(a): S = 1 over NCCL: the partitioned forward and train step
    against the unpartitioned phase-C stack on the same graph and
    weights, eager and captured; launches, times, peak memory."""
    import os
    import tempfile
    import torch.distributed as dist
    from graphnets_tpu_torch.parallel import _comm
    from graphnets_tpu_torch.parallel import edge_partition as ep
    from graphnets_tpu_torch.parallel import edge_partition_stack as eps
    from graphnets_tpu_torch.parallel.distributed import init_distributed
    from graphnets_tpu_torch.parallel.mesh import make_mesh
    bf = torch.bfloat16
    t0 = time.perf_counter()
    a = partitioned_arrays()
    build_s = time.perf_counter() - t0
    g, order = whole_graph(torch, pt, a, bf)
    if not np.array_equal(order, np.arange(len(order))):
        raise SystemExit("G(a): the graph's receivers do not ascend")
    y = g.with_features(ef=torch.from_numpy(a["y_ef"]).to("cuda", bf),
                        nf=torch.from_numpy(a["y_nf"]).to("cuda", bf),
                        gf=None)
    lg32, plan, ys32, pg, plan_s = local_shard(torch, ep, a, 1, 0)
    lg, y_nf, y_ef = as_dtype(lg32, bf), ys32[0].to(bf), ys32[1].to(bf)
    if not np.array_equal(pg.edge_index[0], np.arange(G_N * G_DEG)):
        raise SystemExit("G(a): S = 1 reordered the edges")
    out = {"build_s": build_s, "plan_s": plan_s,
           "halo": plan.halo_size}
    work = tempfile.mkdtemp(prefix="chip_smoke_g_")
    init_distributed(f"file://{os.path.join(work, 'store')}", 1, 0,
                     device="cuda", timeout_s=G_TIMEOUT_S)
    try:
        if dist.get_backend() != "nccl":
            raise SystemExit(f"G(a): backend {dist.get_backend()}, not nccl")
        mesh = make_mesh((1,), ("graph",))
        pt.enable_kernels(True)
        # Forward, inference, bf16 parameters.
        model = g_cores(torch, pt).to(bf)
        with torch.no_grad():
            zero_counts()
            c0 = _comm.COLLECTIVES
            yp = eps.gn_core_list_partitioned(model, lg, plan, mesh)
            torch.cuda.synchronize()
            out["fwd_launches"] = read_counts()
            out["fwd_collectives"] = _comm.COLLECTIVES - c0
            zero_counts()
            yu = model(g)
            torch.cuda.synchronize()
            out["unpart_fwd_launches"] = read_counts()
            got = (yp.ef[0], yp.nf[0], yp.gf)
            ref = (yu.ef, yu.nf, yu.gf)
            out["fwd_err"] = feature_errors(got, ref)
            out["fwd_bit_equal"] = all(torch.equal(x, r)
                                       for x, r in zip(got, ref))
            out["fwd_rows"] = [t.cpu() for t in got]
            out["fwd_ms"] = cuda_ms(torch, lambda: eps.gn_core_list_partitioned(
                model, lg, plan, mesh), iters=3, warmup=1)
            out["unpart_fwd_ms"] = cuda_ms(torch, lambda: model(g), iters=3,
                                           warmup=1)
        del model, yp, yu, got, ref
        want_counts(out["fwd_launches"],
                    dict(edge_g1_agg=G_CORES, ffn=2 * G_CORES),
                    "G(a) partitioned forward")
        log(f"G(a) partitioned forward S = 1: launches "
            f"{out['fwd_launches']} (the unpartitioned stack's "
            f"{out['unpart_fwd_launches']}), {out['fwd_collectives']} "
            f"collectives; against the unpartitioned stack (max err / max "
            f"|ref|) {out['fwd_err']}, bit-equal {out['fwd_bit_equal']} "
            f"(tolerance 5e-2); {out['fwd_ms']:.4f} ms eager against "
            f"{out['unpart_fwd_ms']:.4f} ms, ratio "
            f"{out['fwd_ms'] / out['unpart_fwd_ms']:.4f}; {where}")
        if max(out["fwd_err"].values()) > 5e-2:
            raise SystemExit("G(a): the partitioned forward disagrees with "
                             "the unpartitioned stack")

        # The train step: f32 masters, bf16 compute, AdamW(3e-4), eager.
        def build_part():
            m = g_cores(torch, pt)
            return m, eps.make_partitioned_core_list_train_step(
                m, pt.adamw(m.parameters(), G_LR), plan, mesh,
                compute_dtype=bf)

        def build_unpart():
            m = g_cores(torch, pt)
            return m, pt.make_train_step(m, pt.adamw(m.parameters(), G_LR),
                                         compute_dtype=bf)

        gib = lambda b: b / 2 ** 30
        steps = {}
        for name, build, args in (("part", build_part, (lg, y_nf, y_ef)),
                                  ("unpart", build_unpart, (g, y))):
            m, step = build()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            c0 = _comm.COLLECTIVES
            loss = float(step(*args)["loss"])
            torch.cuda.synchronize()
            steps[name] = {
                "loss": loss, "launches": read_counts(),
                "collectives": _comm.COLLECTIVES - c0,
                "peak_gb": gib(torch.cuda.max_memory_allocated()),
                "own_gb": gib(torch.cuda.max_memory_allocated() - base),
                "params": {n: p.detach().cpu()
                           for n, p in m.named_parameters()},
                "ms": cuda_ms(torch, lambda: step(*args), iters=3,
                              warmup=0)}
            del m, step
        part, unpart = steps["part"], steps["unpart"]
        rel = abs(part["loss"] - unpart["loss"]) / abs(unpart["loss"])
        diff = {k: (part["launches"][k], unpart["launches"][k])
                for k in part["launches"]
                if part["launches"][k] != unpart["launches"][k]}
        log(f"G(a) partitioned train step S = 1: loss {part['loss']:.6f} "
            f"against the unpartitioned step's {unpart['loss']:.6f} "
            f"({rel:.3e} relative, tolerance 1e-2); launches "
            f"{part['launches']}, the unpartitioned step's "
            f"{unpart['launches']}, differences {diff}; "
            f"{part['collectives']} collectives; eager {part['ms']:.4f} ms "
            f"against {unpart['ms']:.4f} ms, ratio "
            f"{part['ms'] / unpart['ms']:.4f}; peak device memory "
            f"{part['peak_gb']:.4f} GiB ({part['own_gb']:.4f} its own) "
            f"against {unpart['peak_gb']:.4f} ({unpart['own_gb']:.4f}); "
            f"{where}")
        want_counts(part["launches"],
                    dict(edge_g1_agg=G_CORES, ffn=2 * G_CORES,
                         ffn_backward=2 * G_CORES, ln_backward=G_CORES,
                         segment_sum=2 * G_CORES, gather=G_CORES),
                    "G(a) partitioned train step")
        if rel > 1e-2 or not np.isfinite(part["loss"]):
            raise SystemExit("G(a): the partitioned step disagrees with the "
                             "unpartitioned step")
        out["step"] = {k: {kk: v for kk, v in d.items() if kk != "params"}
                       for k, d in steps.items()}
        del steps, part, unpart
        torch.cuda.empty_cache()
        # The references of G(b): the same step with the node set composed
        # as a shard's is, in bf16 and in f32; and the witness of its f32
        # noise: that f32 step on the same graph with each node's edges in
        # another order (the same function, other summation orders).
        out["matched"] = partitioned_steps(torch, pt, eps, plan, mesh, lg32,
                                           ys32, route_matched=True)
        del lg32, ys32
        torch.cuda.empty_cache()
        lgr, planr, ysr, _, _ = local_shard(torch, ep, reordered_arrays(a),
                                            1, 0)
        out["reordered"] = partitioned_steps(torch, pt, eps, planr, mesh,
                                             lgr, ysr, route_matched=True,
                                             names=("f32",))["f32"]
        del lgr, planr, ysr
        torch.cuda.empty_cache()
        # Captured against eager, both paths, one after the other.
        per_step = dict(edge_g1_agg=G_CORES, ffn=2 * G_CORES,
                        ffn_backward=2 * G_CORES, ln_backward=G_CORES,
                        segment_sum=2 * G_CORES, gather=G_CORES)
        out["captured"] = captured_check(
            torch, pt, build_part, (lg, y_nf, y_ef), G_LR, per_step,
            zero_counts, read_counts, "partitioned train step S = 1")
        torch.cuda.empty_cache()
        out["unpart_captured"] = captured_check(
            torch, pt, build_unpart, (g, y), G_LR, per_step, zero_counts,
            read_counts, "unpartitioned train step (G's graph)")
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    c, u = out["captured"], out["unpart_captured"]
    log(f"G(a) captured: partitioned {c['captured_ms']:.4f} ms (eager twin "
        f"{c['eager_ms']:.4f}), unpartitioned {u['captured_ms']:.4f} ms "
        f"(eager twin {u['eager_ms']:.4f}), ratio "
        f"{c['captured_ms'] / u['captured_ms']:.4f}; one profiled replay "
        f"{c['replay_kernels']} kernels of {c['replay_busy_ms'] or 0:.4f} ms "
        f"against {u['replay_kernels']} of {u['replay_busy_ms'] or 0:.4f} "
        f"ms; {where}")
    return out


def partitioned_ranks(rank, world):
    """G(b)-(d), one of two ranks on ``cuda:0`` over gloo (the parent
    built the kernels): the large graph's S = 2 forward and one train
    step; the v1 / v2 / v3 blocks on the smaller graph; its locality and
    min-cut partitions under v2.  Returns the rows, the losses and
    parameters, and each path's launches, collectives and host-staged
    calls."""
    import torch
    import graphnets_tpu_torch as pt
    from graphnets_tpu_torch.parallel import _comm
    from graphnets_tpu_torch.parallel import edge_partition as ep
    from graphnets_tpu_torch.parallel import edge_partition_stack as eps
    from graphnets_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    zero_counts, read_counts = kernel_counters()
    pt.enable_kernels(True)
    bf, host = torch.bfloat16, lambda t: t.detach().cpu()
    mesh = make_mesh((2,), ("graph",))
    out = {}

    def counted(fn):
        zero_counts()
        c0, s0 = _comm.COLLECTIVES, _comm.HOST_STAGED
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, {"launches": read_counts(),
                        "collectives": _comm.COLLECTIVES - c0,
                        "host_staged": _comm.HOST_STAGED - s0,
                        "s": time.perf_counter() - t0}

    # (b) The large graph over two shards.
    a = partitioned_arrays()
    lg32, plan, ys32, pg, plan_s = local_shard(torch, ep, a, 2, rank)
    del a
    lg = as_dtype(lg32, bf)
    model = g_cores(torch, pt).to(bf)
    with torch.no_grad():
        y, info = counted(lambda: eps.gn_core_list_partitioned(
            model, lg, plan, mesh))
    out["fwd"] = dict(info, rows=[host(y.ef[0]), host(y.nf[0]),
                                  host(y.gf)],
                      edge_index=pg.edge_index[rank], npad=pg.nodes_per_shard,
                      halo=plan.halo_size, plan_s=plan_s)
    del model, y
    model = g_cores(torch, pt)
    step = eps.make_partitioned_core_list_train_step(
        model, pt.adamw(model.parameters(), G_LR), plan, mesh,
        compute_dtype=bf)
    m, info = counted(lambda: step(lg, ys32[0].to(bf), ys32[1].to(bf)))
    out["step"] = dict(info, loss=float(m["loss"]))
    del model, step, lg
    torch.cuda.empty_cache()
    # The f32 step, whose parameters are held to (a)'s.
    out["step_f32"] = partitioned_steps(torch, pt, eps, plan, mesh, lg32,
                                        ys32, route_matched=False)["f32"]
    del lg32, ys32, plan, pg
    torch.cuda.empty_cache()

    # (c) The blocks at the headline width on the smaller graph.
    a = local_arrays()
    lg, plan, _, pg, _ = local_shard(torch, ep, a, 2, rank, targets=False)
    lg = as_dtype(lg, bf)
    block = pt.GNBlock((D,) * 3, (D,) * 3, generator=torch.Generator()
                       .manual_seed(0)).to(bf)
    out["blocks"] = {"edge_index": pg.edge_index[rank],
                     "npad": pg.nodes_per_shard, "halo": plan.halo_size}
    with torch.no_grad():
        for name, fn in (
                ("v1", lambda: ep.gn_block_partitioned(block, lg, mesh)),
                ("v2", lambda: ep.gn_block_partitioned_halo(block, lg, plan,
                                                            mesh)),
                ("v3", lambda: ep.gn_block_partitioned_overlap(
                    block, lg, plan, mesh))):
            y, info = counted(fn)
            out["blocks"][name] = dict(info, rows=[host(y.ef[0]),
                                                   host(y.nf[0]),
                                                   host(y.gf)])

    # (d) The locality and min-cut partitions under v2.
    for name, fn in (("locality", ep.partition_edges_locality),
                     ("mincut", ep.partition_edges_mincut)):
        t0 = time.perf_counter()
        pgl, order = fn(a["senders"], a["receivers"], a["nf"], 2,
                        ef=a["ef"], gf=a["gf"], device="cpu")
        part_s = time.perf_counter() - t0
        planl = ep.build_halo_plan(pgl)
        x = pgl.shard(rank, "cuda").replace(edge_index=None)
        x = x.replace(ef=x.ef.to(bf), nf=x.nf.to(bf), gf=x.gf.to(bf))
        with torch.no_grad():
            y, info = counted(lambda: ep.gn_block_partitioned_halo(
                block, x, planl.shard(rank, "cuda"), mesh))
        out[name] = dict(info, rows=[host(y.ef[0]), host(y.nf[0]),
                                     host(y.gf)],
                         edge_index=pgl.edge_index[rank],
                         node_mask=pgl.node_mask.numpy(), order=order,
                         npad=pgl.nodes_per_shard, halo=planl.halo_size,
                         partition_s=part_s)

    # The v3 core on the min-cut layout, whose shards hold pad slots on
    # the overflow segment: under training the single-graph edge update
    # with its sum, and with that sum off the composed route (the sorted
    # gather with its addend, ln_matmul, the sorted sum over Npad + 1
    # segments), each against the plain route on the same inputs.  The
    # real rows only: a pad slot's row is junk, and the routes' junk
    # differs.
    from graphnets_tpu_torch.utils.config import get_config
    em, nm = x.edge_mask[0], x.node_mask[0]
    core = pt.GNCoreList([pt.GNCore((D,) * 3, generator=torch.Generator()
                                    .manual_seed(1))]).to(bf)
    lp = planl.shard(rank, "cuda")
    from graphnets_tpu_torch.ops.kernels.gather import supports_sorted_gather
    # JAX's gate for the sorted gather wants a table of a multiple of 32
    # rows, which an imbalanced shard's Npad need not be.
    out["padded_v3"] = {"pads": int((~em).sum()), "gather_add": int(
        supports_sorted_gather(em.shape[0], nm.shape[0], D, 2))}
    try:
        for route in ("g1", "composed"):
            get_config().g1_agg_fusion_training = route == "g1"
            res = []
            for kernels in (True, False):
                pt.enable_kernels(kernels)
                with torch.no_grad():
                    y, info = counted(lambda: eps.gn_core_list_partitioned(
                        core, x, lp, mesh, training=True))
                res.append((info["launches"],
                            [host(y.ef[0][em]), host(y.nf[0][nm]),
                             host(y.gf)]))
            out["padded_v3"][route] = {
                "launches": res[0][0], "plain_launches": res[1][0],
                "errors": feature_errors(res[0][1], res[1][1])}
    finally:
        get_config().g1_agg_fusion_training = True
        pt.enable_kernels(True)
    return out


def cut_edges(a, assign):
    """Edges whose sender and receiver lie on different shards."""
    return int(np.sum(assign[a["senders"]] != assign[a["receivers"]]))


def partitioned_phase(torch, pt, zero_counts, read_counts, where, ltrain):
    """Phase G: (a) S = 1 over NCCL against the unpartitioned stack; (b)
    S = 2 over two processes sharing the card (gloo) against (a); (c) the
    v1 / v2 / v3 blocks at S = 2 against each other and the unpartitioned
    GNBlock; (d) the locality and min-cut partitioners.  Raises
    ``SystemExit`` on any miss."""
    import os
    import tempfile
    from graphnets_tpu_torch.parallel.launch import run_ranks
    t_g = time.perf_counter()
    out = {"a": partitioned_s1(torch, pt, zero_counts, read_counts, where)}
    a1 = out["a"]
    if ltrain is not None:
        log(f"G(a) launches of the partitioned step against phase C's step "
            f"(another graph of C's size, the same stack): "
            f"{a1['step']['part']['launches']} / {ltrain['launches']}; its "
            f"eager time {a1['step']['part']['ms']:.4f} ms against C's "
            f"{ltrain['step_ms']:.4f} ms, ratio "
            f"{a1['step']['part']['ms'] / ltrain['step_ms']:.4f}; {where}")
    log(f"G(a) the halo plan at {G_N * G_DEG} edges built in "
        f"{a1['plan_s']:.3f} s (the graph {a1['build_s']:.3f} s)")

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_g_")
    ranks = run_ranks(partitioned_ranks, 2, os.path.join(work, "ranks"),
                      device="cuda", backend="gloo", timeout_s=G_TIMEOUT_S,
                      threads=4)
    out["spawn_s"] = time.perf_counter() - t0
    bf = torch.bfloat16

    # (b) Each rank's rows against (a)'s, through edge_index.
    ref = a1.pop("fwd_rows")
    worst = {}
    for r, got in enumerate(ranks):
        f = got["fwd"]
        ei = f["edge_index"]
        k = int((ei >= 0).sum())
        npad = f["npad"]
        rows = (f["rows"][0][:k], f["rows"][1],
                f["rows"][2])
        want = (ref[0][torch.from_numpy(ei[:k])],
                ref[1][r * npad:(r + 1) * npad], ref[2])
        errs = feature_errors(rows, want)
        worst = {key: max(worst.get(key, 0.0), v) for key, v in errs.items()}
    matched = a1.pop("matched")
    ref_loss = matched["bf16"]["loss"]
    step_rel = [abs(got["step"]["loss"] - ref_loss) / abs(ref_loss)
                for got in ranks]
    rel32 = [abs(got["step_f32"]["loss"] - matched["f32"]["loss"])
             / abs(matched["f32"]["loss"]) for got in ranks]
    # f32 gradients: sums over a million rows in another order, and the
    # pools' f32 sum in another order moves rows by an ulp, which flips
    # the relu masks of pre-activations within rounding of 0.  The witness
    # is (a)'s f32 step on the same graph with each node's edges in another
    # order: the same function, other sums, and the same kind of gaps.  So,
    # as C's gradients (section 2), they are held in the 2-norm, within
    # 1e-3 of the S = 1 tensor's norm (A's f32 bound), and the largest
    # element is printed beside the witness's.  After one AdamW step a
    # parameter moves by about lr x sign(gradient), so a parameter may part
    # from S = 1's by up to 2 lr where its gradient lies within that noise
    # of 0, and only there: every element that breaks the captured-vs-eager
    # rule must have an S = 1 gradient within 4 times the witness's largest
    # gap in its tensor.
    s1, wit = matched["f32"], a1.pop("reordered")

    def grad_gaps(grads):
        """(worst 2-norm share of 1e-3, tensor), (worst element over the
        largest magnitude, tensor) against S = 1's gradients."""
        return (max((float((grads[n] - q).norm())
                     / (1e-3 * max(float(q.norm()), 1e-30)), n)
                    for n, q in s1["grads"].items()),
                max((float((grads[n] - q).abs().max())
                     / max(float(q.abs().max()), 1e-30), n)
                    for n, q in s1["grads"].items() if q.numel()))

    def held_params(params):
        """The elements that break the captured-vs-eager rule: (the
        largest |S = 1 gradient| among them over 4 x the witness's largest
        gap in its tensor, tensor), their count, elements in all."""
        worst, broken, total = (0.0, ""), 0, 0
        for n, q in s1["params"].items():
            if not q.numel():
                continue
            g = s1["grads"][n]
            noise = 4 * float((wit["grads"][n] - g).abs().max())
            bound = 1e-5 * float(q.abs().max()) + 0.1 * G_LR
            off = (params[n] - q).abs() > bound
            if off.any():
                worst = max(worst, (float(g[off].abs().max())
                                    / max(noise, 1e-30), n))
            broken += int(off.sum())
            total += q.numel()
        return worst, broken, total

    wit_norm, wit_top = grad_gaps(wit["grads"])
    wit_param = param_rule(torch, wit["params"], s1["params"], G_LR,
                           "G(b) witness")
    gaps = [grad_gaps(got["step_f32"]["grads"]) for got in ranks]
    grad_norm, grad_top = max(g[0] for g in gaps), max(g[1] for g in gaps)
    param_all = max(param_rule(torch, got["step_f32"]["params"],
                               s1["params"], G_LR, "G(b)")
                    for got in ranks)
    held = [held_params(got["step_f32"]["params"]) for got in ranks]
    param_worst = max(h[0] for h in held)
    broken = max(h[1] for h in held), held[0][2]
    same_params = all(torch.equal(ranks[0]["step_f32"]["params"][n], p)
                      for n, p in ranks[1]["step_f32"]["params"].items())
    want_fwd = dict(edge_g1_agg=G_CORES, ffn=2 * G_CORES)
    # A shard's 32,768 node rows are under the fused FFN's training row
    # gate (65,536): the node set composes, the edge set stays fused.
    want_step = dict(edge_g1_agg=G_CORES, ffn=G_CORES,
                     ffn_backward=G_CORES, ln_backward=G_CORES,
                     segment_sum=2 * G_CORES, gather=G_CORES)
    for r, got in enumerate(ranks):
        f, s = got["fwd"], got["step"]
        log(f"G(b) rank {r}: forward launches {f['launches']}, "
            f"{f['collectives']} collectives ({f['host_staged']} staged "
            f"through the host), {f['s']:.3f} s; train step launches "
            f"{s['launches']}, {s['collectives']} collectives "
            f"({s['host_staged']} staged), {s['s']:.3f} s, loss "
            f"{s['loss']:.6f}; halo H = {f['halo']} rows of {f['npad']}, "
            f"plan built in {f['plan_s']:.3f} s")
        want_counts(f["launches"], want_fwd, f"G(b) rank {r} forward")
        want_counts(s["launches"], want_step, f"G(b) rank {r} train step")
        # Forward: an all-to-all and a psum a core.  The step adds the
        # loss's psum, the backward of each all-to-all and of each psum but
        # the last core's (its graph update reaches no loss term), the
        # loss psum's backward and the gradients' all-reduce.
        want_coll = (2 * G_CORES, 4 * G_CORES + 2)
        if (f["collectives"], s["collectives"]) != want_coll:
            raise SystemExit(f"G(b) rank {r}: {f['collectives']} / "
                             f"{s['collectives']} collectives, expected "
                             f"{want_coll}")
    log(f"G(b) S = 2 against (a): forward rows (max err / max |ref| of "
        f"each feature set, both ranks) {worst} (tolerance 5e-2); bf16 step "
        f"losses {[got['step']['loss'] for got in ranks]} against the S = 1 "
        f"step on the same routes {ref_loss:.7f} ({max(step_rel):.3e} "
        f"relative, tolerance 1e-4; the S = 1 step with its node set fused "
        f"{a1['step']['part']['loss']:.7f}); f32 step losses "
        f"{[got['step_f32']['loss'] for got in ranks]} against "
        f"{matched['f32']['loss']:.7f} ({max(rel32):.3e} relative, "
        f"tolerance 1e-4), worst gradient {grad_norm[1]} at "
        f"{grad_norm[0]:.4f} of 1e-3 of its 2-norm (the witness, S = 1 "
        f"with each node's edges reordered: {wit_norm[1]} at "
        f"{wit_norm[0]:.4f}); largest element gap {grad_top[1]} at "
        f"{grad_top[0]:.3e} of its largest magnitude (the witness: "
        f"{wit_top[1]} at {wit_top[0]:.3e}); the ranks' parameters after "
        f"it bit-equal {same_params}; against S = 1's the captured-vs-eager "
        f"rule's worst share on every element {param_all} (the witness: "
        f"{wit_param}); {broken[0]} of {broken[1]} elements break it, "
        f"the largest S = 1 gradient among them at {param_worst[0]:.4f} of "
        f"4 x the witness's largest gap in its tensor ({param_worst[1]}; "
        f"tolerance 1); {where}")
    if (max(worst.values()) > 5e-2 or max(step_rel) > 1e-4
            or max(rel32) > 1e-4 or grad_norm[0] > 1.0 or not same_params
            or param_worst[0] > 1.0):
        raise SystemExit("G(b): S = 2 disagrees with S = 1")
    out["b"] = {"fwd_err": worst, "loss_rel": max(step_rel),
                "loss_rel_f32": max(rel32), "worst_grad_norm": grad_norm,
                "worst_grad_top": grad_top, "witness_grad_norm": wit_norm,
                "witness_grad_top": wit_top, "witness_param": wit_param,
                "worst_param_all": param_all, "worst_param": param_worst,
                "params_broken": broken,
                "ranks": [{k: {kk: v for kk, v in got[k].items()
                               if kk in ("launches", "collectives",
                                         "host_staged", "s", "loss", "halo",
                                         "plan_s")}
                           for k in ("fwd", "step")} for got in ranks]}

    # (c) The blocks against each other and the unpartitioned GNBlock.
    pt.enable_kernels(True)
    a = local_arrays()
    g, order = whole_graph(torch, pt, a, bf)
    block = pt.GNBlock((D,) * 3, (D,) * 3, generator=torch.Generator()
                       .manual_seed(0)).to(bf)
    zero_counts()
    with torch.no_grad():
        yu = block(g)
    torch.cuda.synchronize()
    unpart_launches = read_counts()
    ef_u = torch.empty_like(yu.ef)
    ef_u[torch.from_numpy(order).cuda()] = yu.ef
    ref = (ef_u.cpu(), yu.nf.cpu(), yu.gf.cpu())

    def mapped(rows_by_rank, key):
        """Every rank's rows of ``key`` in the input order."""
        ef = torch.empty_like(ref[0])
        nf = []
        for r, got in enumerate(ranks):
            info, rows = got["blocks"], rows_by_rank[r]
            ei = info["edge_index"]
            k = int((ei >= 0).sum())
            ef[torch.from_numpy(ei[:k])] = rows[0][:k]
            nf.append(rows[1])
        return ef, torch.cat(nf)[:G_SMALL_N], rows_by_rank[0][2]

    blocks = {v: mapped([got["blocks"][v]["rows"] for got in ranks], v)
              for v in ("v1", "v2", "v3")}
    errs = {v: feature_errors(blocks[v], ref) for v in blocks}
    errs["v2 vs v1"] = feature_errors(blocks["v2"], blocks["v1"])
    errs["v3 vs v1"] = feature_errors(blocks["v3"], blocks["v1"])
    launches_c = {v: ranks[0]["blocks"][v]["launches"] for v in blocks}
    collectives_c = {v: (ranks[0]["blocks"][v]["collectives"],
                         ranks[0]["blocks"][v]["host_staged"])
                     for v in blocks}
    log(f"G(c) blocks at S = 2 ((384,)*3, bf16, N = {G_SMALL_N}, E = "
        f"{G_SMALL_N * G_SMALL_DEG}, halo H = "
        f"{ranks[0]['blocks']['halo']} of {ranks[0]['blocks']['npad']}): "
        f"max err / max |ref| {errs} (tolerance 5e-2); rank 0 launches "
        f"{launches_c}, collectives (all, host-staged) {collectives_c}; the "
        f"unpartitioned GNBlock's launches {unpart_launches}")
    if max(max(e.values()) for e in errs.values()) > 5e-2:
        raise SystemExit("G(c): the partitioned blocks disagree")
    for v in blocks:
        want_counts(launches_c[v], dict(edge_g1_agg=1) if v == "v3" else {},
                    f"G(c) {v}")

    # (d) The partitioners: fewer cut edges than contiguous blocks, and v2
    # on their layouts equal to the unpartitioned block.
    S = 2
    npad = -(-G_SMALL_N // S)
    cuts = {"contiguous": cut_edges(a, np.minimum(
        np.arange(G_SMALL_N) // npad, S - 1))}
    errs_d, halos = {}, {"contiguous": ranks[0]["blocks"]["halo"]}
    for name in ("locality", "mincut"):
        info0 = ranks[0][name]
        order_d, nm, npad_d = info0["order"], info0["node_mask"], \
            info0["npad"]
        # The shard of each old node, from the relabelling.
        new_of_old = np.empty(G_SMALL_N, np.int64)
        pos = 0
        for s in range(S):
            k = int(nm[s].sum())
            new_of_old[order_d[pos:pos + k]] = s * npad_d + np.arange(k)
            pos += k
        cuts[name] = cut_edges(a, new_of_old // npad_d)
        halos[name] = info0["halo"]
        ef = torch.empty_like(ref[0])
        nf_rows = []
        for r, got in enumerate(ranks):
            ei = got[name]["edge_index"]
            k = int((ei >= 0).sum())
            ef[torch.from_numpy(ei[:k])] = got[name]["rows"][0][:k]
            nf_rows.append(got[name]["rows"][1])
        nf = torch.cat(nf_rows)[torch.from_numpy(new_of_old)]
        errs_d[name] = feature_errors((ef, nf, ranks[0][name]["rows"][2]),
                                      ref)
    # The v3 core on the min-cut layout's pad slots, kernel route against
    # plain route.
    padded = [got["padded_v3"] for got in ranks]
    log(f"G(d) the v3 core (GNCore (384,)*3, bf16, training) on the "
        f"min-cut layout, pad slots by rank {[p['pads'] for p in padded]}: "
        f"kernel route against plain route (max err / max |ref|, real rows) "
        f"{[{r: p[r]['errors'] for r in ('g1', 'composed')} for p in padded]}"
        f" (tolerance 5e-2); rank 0 launches "
        f"{ {r: padded[0][r]['launches'] for r in ('g1', 'composed')} }, "
        f"the plain route's "
        f"{ {r: padded[0][r]['plain_launches'] for r in ('g1', 'composed')} }"
        f"; {where}")
    if not any(p["pads"] for p in padded):
        raise SystemExit("G(d): the min-cut layout has no pad slot")
    for r, p in enumerate(padded):
        if max(max(p[k]["errors"].values()) for k in ("g1", "composed")) \
                > 5e-2:
            raise SystemExit(f"G(d) rank {r}: the v3 core on the padded "
                             f"layout disagrees with its plain route")
        want_counts(p["g1"]["launches"], dict(edge_g1_agg=1),
                    f"G(d) rank {r} v3 padded, single-graph route")
        want_counts(p["composed"]["launches"],
                    dict(gather_add=p["gather_add"], ln_matmul=1,
                         segment_sum=1),
                    f"G(d) rank {r} v3 padded, composed route")
        for k in ("g1", "composed"):
            if any(p[k]["plain_launches"].values()):
                raise SystemExit(f"G(d) rank {r}: the plain route launched "
                                 f"{p[k]['plain_launches']}")
    log(f"G(d) partitioners on the smaller graph (S = 2): cut edges {cuts} "
        f"of {G_SMALL_N * G_SMALL_DEG}, halo H {halos}; v2 on their layouts "
        f"against the unpartitioned block {errs_d} (tolerance 5e-2); "
        f"partition times {[(n, round(ranks[0][n]['partition_s'], 3)) for n in ('locality', 'mincut')]} s")
    if (cuts["locality"] >= cuts["contiguous"]
            or cuts["mincut"] >= cuts["contiguous"]
            or max(max(e.values()) for e in errs_d.values()) > 5e-2):
        raise SystemExit("G(d): a partitioner cut no fewer edges than "
                         "contiguous blocks, or its v2 result disagrees")
    out["c"] = {"errors": errs, "launches": launches_c,
                "collectives": collectives_c, "unpart_launches":
                unpart_launches}
    out["d"] = {"cuts": cuts, "halos": halos, "errors": errs_d,
                "padded_v3": padded}
    out["launches"] = {
        "partitioned_forward": a1["fwd_launches"],
        "partitioned_train_step": a1["step"]["part"]["launches"],
        "partitioned_train_step_captured": a1["captured"]["launches"],
        "partitioned_s2_forward": ranks[0]["fwd"]["launches"],
        "partitioned_s2_train_step": ranks[0]["step"]["launches"],
        "partitioned_v3_block_s2": launches_c["v3"]}
    out["s"] = time.perf_counter() - t_g
    log(f"phase G took {out['s']:.1f} s (the two ranks {out['spawn_s']:.1f}"
        f" s of it, their start included); {where}")
    return out


# The crossover sweep of ``--phase sums``: (graphs, nodes and edges a
# graph) with 128 to 1024 edges a graph, 2048 to 8192 rows.
SWEEP = ((16, 16, 128), (24, 16, 128), (32, 16, 128), (40, 16, 128),
         (64, 16, 128), (4, 32, 512), (8, 32, 512), (16, 32, 512),
         (2, 64, 1024), (4, 64, 1024), (8, 64, 1024))


def crossover_sweep(torch, ss, where):
    """Device times of the one-pass kernel (at the plan ``small_plan``
    gives its shape, rows and windows aside) and of the large-row kernels
    on the ``SWEEP`` layouts, sorted and windowed ids, bf16 and f32 rows,
    d = 384 and 128: where ``small_plan``'s crossover comes from."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (G, npg, epg) in enumerate(SWEEP):
        g = crossover_graph(torch, G, 100 + i, npg, epg)
        N, E = G * npg, G * epg
        gi = torch.arange(G + 1, dtype=torch.int32, device=g.device)
        wins = (gi * npg, gi * epg)
        for dtype in (torch.bfloat16, torch.float32):
            for d in (384, 128):
                plan = ss.small_plan(1, N, d, dtype, sms, graphs=G)
                if plan is None:  # more than two blocks an SM
                    continue
                x = torch.randn(E, d, device=g.device).to(dtype)
                planned = [ss.small_plan(E, N, d, dtype, sms, graphs=k)
                           is not None for k in (None, G)]
                r = {"E": E, "N": N, "G": G, "d": d, "dtype": str(dtype),
                     "tile": plan.tile, "planned_sorted": planned[0],
                     "planned_windowed": planned[1]}
                with torch.no_grad():
                    r["one_pass_sorted_ms"] = graph_ms(
                        torch, lambda: ss._launch_sorted_small(
                            x, g.receivers, N, plan))
                    r["chunked_ms"] = graph_ms(
                        torch, lambda: ss._launch_sorted(x, g.receivers, N))
                    r["one_pass_windowed_ms"] = graph_ms(
                        torch, lambda: ss._launch_windowed_small(
                            x, g.senders, N, *wins, plan))
                    r["large_windowed_ms"] = graph_ms(
                        torch, lambda: ss._launch_windowed(x, g.senders, N,
                                                           *wins))
                rows.append(r)
                log(f"crossover E={E} N={N} G={G} d={d} {dtype}: one-pass "
                    f"{r['one_pass_sorted_ms']:.4f} / "
                    f"{r['one_pass_windowed_ms']:.4f} ms, large-row "
                    f"{r['chunked_ms']:.4f} / {r['large_windowed_ms']:.4f} "
                    f"ms (sorted / windowed), one-pass planned {planned}; "
                    f"{where}")
    return rows


def edge_order_case(torch, ss, where, seed=91):
    """The senders' fallback where the windowed gate refuses a width
    (``edge_order_segment_sum``: ids sorted stably, rows gathered in that
    order, each tile's rows added in edge order, every add rounded) on
    one graph of C's size at d = 64 ([1,048,576, 64] bf16 -> 65,536, ids
    drawn uniformly): bit-equal to its plain version and to a relaunch;
    device times of 5 eager calls between CUDA events, beside
    ``index_add_`` into a bf16 buffer, the bound, and the sort and gather
    alone (``sort_gather_ms``: the wrapper's work before its kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, N, d = LG_E, LG_N, 64
    seg = torch.randint(0, N, (E,), generator=gen, device="cuda",
                        dtype=torch.int32)
    x = torch.randn(E, d, generator=gen, device="cuda").to(torch.bfloat16)
    seg_long = seg.long()
    kernel = lambda: ss.edge_order_segment_sum(x, seg, N)
    plain = lambda: ss.edge_order_segment_sum_plain(x, seg, N)
    library = lambda: torch.zeros(N, d, dtype=torch.bfloat16,
                                  device="cuda").index_add_(0, seg_long, x)
    out, again, ref = kernel(), kernel(), plain()
    ok = bool(torch.equal(out, again) and torch.equal(out, ref))
    bms, by = bound_ms(E * d * 2 + E * 4 + N * d * 2, 0, flops_f32=E * d)
    case = {"shape": f"edge-order E={E} N={N} G=1 d={d} bf16",
            "bit_equal_plain_and_relaunch": ok,
            **timed(torch, kernel, plain, library, large=True),
            "sort_gather_ms": cuda_ms(torch, lambda: x.index_select(
                0, torch.sort(seg, stable=True)[1]), iters=LARGE_ITERS,
                warmup=1),
            "bound_ms": bms, "bound_by": by}
    log(f"segment sum {case['shape']}: {case['kernel_ms']:.4f} ms (sort "
        f"and gather {case['sort_gather_ms']:.4f}), index_add_ "
        f"{case['library_ms']:.4f} ms, bound {bms:.4f} ms, plain "
        f"{case['plain_ms']:.4f} ms; bit-equal {ok}; {where}")
    if not ok:
        raise SystemExit("edge_order_segment_sum disagrees with its plain "
                         "version or a relaunch")
    return case


def sums_phase(torch, pt, ss, zero_counts, read_counts, where):
    """``--phase sums``: the segment sums at phase 3's layouts and the
    crossover's two (:func:`sum_cases`), the crossover sweep
    (:func:`crossover_sweep`), the senders' fallback on one large graph
    (:func:`edge_order_case`), then phases A and S, whose steps take the
    one-pass kernel; their captured step times, launches and busy shares.
    Raises ``SystemExit`` where a sum disagrees with its plain version."""
    uniform = pt.PadSpec.uniform(N_PER_G, N_PER_G * DEG)
    bucketed = pt.PadSpec.bucketed(B * N_PER_G, B * N_PER_G * DEG, B,
                                   node_multiple=32)
    cfg = pt.SortTaskConfig()
    g = dict(
        exact=pt.batch(bench_graphs(0, N_PER_G, DEG, N_PER_G,
                                    N_PER_G * DEG), pad=uniform),
        bucket=pt.batch(bench_graphs(0, N_PER_G, DEG, N_PER_G,
                                     N_PER_G * DEG), pad=bucketed),
        sort=pt.get_batch(np.random.default_rng(0), cfg)[0],
        sort_u=pt.device_batch(torch.Generator(device="cuda").manual_seed(0),
                               cfg, pt.sort_pad_spec(cfg, uniform=True))[0],
        large=large_graph(torch, pt),
        samp=sampled_batch(pt, arxiv_shaped_graph(pt)).graph,
        cross_small=crossover_graph(torch, 16, 0),
        cross_large=crossover_graph(torch, 17, 1))
    seg = sum_cases(torch, ss, g)
    log_sums(seg, where)
    failed = [c["shape"] for cases in seg.values() for c in cases.values()
              if not c["ok"]]
    if failed:
        raise SystemExit(f"a segment sum disagrees with its plain version: "
                         f"{failed}")
    del g
    out = {"sums": seg, "crossover": crossover_sweep(torch, ss, where),
           "edge_order": edge_order_case(torch, ss, where)}
    for name, fn in (("A", sort_phase), ("S", device_sort_phase)):
        r = fn(torch, pt, zero_counts, read_counts)
        # One step's launches (A: through train_sort, its warm-ups and
        # capture included; S: one eager step).
        launches = r.get("first_launches", r.get("step_launches"))
        out[name] = {k: r.get(k) for k in (
            "captured_step_ms", "replay_kernels", "replay_busy_ms",
            "eager_step_ms", "step_ms", "busy_ms", "kernels_per_step",
            "steps_per_sec")}
        out[name]["launches"] = launches
        log(f"{name}: captured step {r['captured_step_ms']:.4f} ms, one "
            f"profiled replay {r['replay_kernels']} kernels of "
            f"{r['replay_busy_ms'] or 0:.4f} ms, busy share "
            f"{busy_share(r['replay_busy_ms'], r['captured_step_ms'])}; "
            f"launches {launches}; {where}")
    return out


def build_phase(_build):
    """Phase 2: build every kernel (all sources at once), print the build
    time and the compiler's register / spill report, and fail unless every
    instance of the ``TC_KERNELS`` shows 0 spill bytes and the f32 kernels
    hold no matrix instruction (:func:`f32_instructions`)."""
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(_build.kernel_names())}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    spills = tensor_core_spills(logs)
    for fn, (stores, loads) in sorted(spills.items()):
        log(f"  spills of {fn}: {stores} bytes stored, {loads} loaded")
    if (any(st or ld for st, ld in spills.values())
            or not all(any(k in fn for fn in spills)
                       for k in TC_KERNELS + TC_POLICIES)):
        raise SystemExit(f"the tensor-core and f32 FFN kernels must build "
                         f"without spills: {spills}")
    for fn, v in sorted(f32_instructions(_build).items()):
        log(f"  SASS of {fn}: {v['FFMA']} FFMA, matrix instructions "
            f"{v['mma'] or 'none'}")


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
    from graphnets_tpu_torch.ops.kernels import edge_update_g1 as g1
    from graphnets_tpu_torch.ops.kernels import fused_ffn as ffn
    from graphnets_tpu_torch.ops.kernels import gather as ga
    from graphnets_tpu_torch.ops.kernels import ln_linear as ll
    from graphnets_tpu_torch.ops.kernels import random_gather as rg
    from graphnets_tpu_torch.ops.kernels import segment_sum as ss

    # Every wrapper's launch count, set to 0 before and read after a path.
    zero_counts, read_counts = kernel_counters()

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

    args = sys.argv[1:]
    phase = args[args.index("--phase") + 1] if "--phase" in args else None
    if phase is not None:
        if phase == "F":
            if "--no-build-checks" in args:
                # An earlier tree's kernels, whose f32 kernels the checks
                # do not all name: built, not checked.
                _build.build()
            else:
                build_phase(_build)  # with the checks on the f32 kernels
            fwd_cases, bwd_cases = f32_ffn_cases(torch, ffn)
            log_f32_ffn(fwd_cases + bwd_cases, where)
            ln_f32, g1_f32 = f32_row_cases(torch, ll, lnp, g1)
            log_f32_ffn(ln_f32, where, "LN->matmul backward")
            log_f32_ffn(g1_f32, where, "single-graph edge update")
            failed = [c["shape"] for c in fwd_cases + bwd_cases + ln_f32
                      + g1_f32 if not c["ok"]]
            if failed:
                raise SystemExit(f"an f32 kernel disagrees with its plain "
                                 f"version: {failed}")
            result = {"ffn_f32": fwd_cases, "ffn_backward_f32": bwd_cases,
                      "ln_backward_f32": ln_f32, "g1_f32": g1_f32,
                      **f32_phase(torch, pt, zero_counts, read_counts,
                                  where)}
        elif phase == "sums":
            _build.build()
            result = sums_phase(torch, pt, ss, zero_counts, read_counts,
                                where)
        elif phase == "G":
            _build.build()
            result = partitioned_phase(torch, pt, zero_counts, read_counts,
                                       where, None)
        elif phase == "gates":
            _build.build()
            result = gates_phase(torch, pt)
        elif phase == "adamw":
            _build.build(["adamw"])
            result = adamw_phase(torch, pt, where)
        elif phase == "split":
            logs = _build.build(["split_edge_layer", "segment_sum",
                                 "gather"])
            result = split_phase(torch, pt, logs, where)
        elif phase == "flagship":
            _build.build()
            seeds = ([int(x) for x in args[args.index("--seeds") + 1]
                      .split(",")] if "--seeds" in args else None)
            result = flagship_phase(torch, pt, seeds)
        else:
            raise SystemExit(f"unknown phase {phase!r}: F, G, sums, gates, "
                             f"adamw, split or flagship")
        log(json.dumps({phase: result, "card": card}))
        if phase == "flagship":
            return 1 if any(r["fault"] for r in result.values()) else 0
        if phase == "split":
            return 0 if all(r["ok"] for r in result.values()) else 1
        return 0

    # 2. Build every kernel.
    build_phase(_build)

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
    # A width the JAX gate admits and the port refused before it took that
    # gate: de = dout = 512 on 16 graphs of 64 / 1024 slots (listed after
    # the headline's cases, whose times head the kernels line).
    edge_cases.append(check_edge_update_wide(torch, eu, 16, 64, 1024, 512,
                                             512, 26))
    gather_cases = [check_gather(torch, ga, g_exact, 31),
                    check_gather(torch, ga, g_bucket, 41)]
    ln_cases = [check_ln_backward(torch, ll, lnp, T_E, 32),
                check_ln_backward(torch, ll, lnp, T_E, 32, two_step=True),
                check_ln_backward(torch, ll, lnp, F_SORT_ROWS, 34,
                                  torch.float32, D=F_SORT_D)]
    bf, f32 = torch.bfloat16, torch.float32
    lnm_cases = [check_ln_matmul(torch, ll, lnp, T_E, 35, bf, f32),
                 check_ln_matmul(torch, ll, lnp, T_E, 36, bf, None),
                 check_ln_matmul(torch, ll, lnp, T_SORT, 37, f32, f32)]
    gather_add_case = check_gather_add(torch, ga, g_bucket, 38)
    # The single-graph route's kernels: the large graph's shapes (bf16
    # partials, since its 1,048,576 gathered rows pass the bf16 gate), the
    # sampled subgraph's (f32 partials, power-law receivers, a hub, empty
    # nodes and pad edges on the last node) and f32 rows.
    g_large = large_graph(torch, pt)
    g1_cases = (check_g1(torch, g1, LG_E, LG_N, LG_D, bf, bf, "uniform", 50,
                         large=True)
                + check_g1(torch, g1, 56320, 56960, LG_D, bf, f32, "power",
                           51)
                + check_g1(torch, g1, *F_G1_SMALL, LG_D, f32, f32, "power",
                           52))
    # f32 rows at F(b)'s shapes: the LN->matmul backward and the
    # single-graph edge update, with and without the sum.
    ln_f32, g1_f32 = f32_row_cases(torch, ll, lnp, g1, small=False)
    g1_cases += g1_f32
    g1_agg_cases, g1_h_cases = g1_cases[0::2], g1_cases[1::2]
    ffn_bwd_cases = [check_ffn_backward(torch, ffn, LG_E, LG_D, 53,
                                        large=True),
                     check_ffn_backward(torch, ffn, LG_N, LG_D, 54),
                     check_ffn_backward(torch, ffn, LG_N, 128, 55),
                     # The rest of the JAX gate: d = 384 and 512, f32 rows.
                     check_ffn_backward(torch, ffn, LG_N, 384, 71),
                     check_ffn_backward(torch, ffn, LG_N, 512, 72)]
    rg_case = check_random_gather(torch, rg, LG_N, LG_D, LG_E, 56)
    # The earlier kernels at the shapes this route gives them.
    ffn_cases += [check_ffn(torch, ffn, LG_E, 57, D=LG_D, large=True),
                  check_ffn(torch, ffn, LG_N, 58, D=LG_D),
                  # The rest of the JAX gate: d = 512, and f32 rows.
                  check_ffn(torch, ffn, T_E, 74, D=512)]
    # f32 rows at phase F's shapes and the rest of the gate's widths.
    ffn_f32_cases, ffn_bwd_f32_cases = f32_ffn_cases(torch, ffn)
    ffn_cases += ffn_f32_cases
    ffn_bwd_cases += ffn_bwd_f32_cases
    ln_cases += [check_ln_backward(torch, ll, lnp, LG_E, 59, D=LG_D,
                                   large=True)] + ln_f32
    gather_cases.append(check_gather(torch, ga, g_large, 61, D=LG_D,
                                     large=True))
    # The sampled route's (D): the first batch's receivers, ~51,670 of
    # whose 56,320 slots are pad edges on the pad node.
    t0 = time.perf_counter()
    ax_graph = arxiv_shaped_graph(pt)
    ax_build_s = time.perf_counter() - t0
    g_samp = sampled_batch(pt, ax_graph).graph
    gather_cases.append(check_gather(torch, ga, g_samp, 81, D=LG_D))
    gather_add_samp = check_gather_add(torch, ga, g_samp, 82, D=LG_D)
    # The repaired wide rows of ln_matmul and its backward: d = dout = 512
    # and 1024 in bf16, 640 in f32.
    lnm_cases += [check_ln_matmul(torch, ll, lnp, T_E, 62, bf, f32, D=512),
                  check_ln_matmul(torch, ll, lnp, T_E, 63, bf, bf, D=1024),
                  check_ln_matmul(torch, ll, lnp, T_E, 64, f32, f32, D=640)]
    ln_cases += [check_ln_backward(torch, ll, lnp, T_E, 65, D=512),
                 check_ln_backward(torch, ll, lnp, T_E, 66, D=1024),
                 check_ln_backward(torch, ll, lnp, T_E, 67, f32, D=640)]
    # Phase S's bf16 variants at their own shapes: ln_matmul and its
    # backward on T_SORT bf16 rows (sort_pad_spec), and the uniform sort
    # layout (4 graphs of 16 node / 128 edge slots, d = 384): both edge
    # updates, the deferred receivers term and both sums on bf16 and f32
    # rows.
    cfg_s = pt.SortTaskConfig()
    g_sort_u, _ = pt.device_batch(
        torch.Generator(device="cuda").manual_seed(0), cfg_s,
        pt.sort_pad_spec(cfg_s, uniform=True))
    if ((g_sort_u.num_node_slots, g_sort_u.num_edge_slots,
         g_sort_u.num_graph_slots, g_sort_u.slot_shape)
            != (64, 512, 4, (16, 128))):
        raise SystemExit("unexpected uniform sort layout from device_batch()")
    edge_cases.append(check_edge_update_wide(torch, eu, 4, 16, 128, D, D,
                                             83))
    lnm_cases.append(check_ln_matmul(torch, ll, lnp, T_SORT, 84, bf, f32))
    ln_cases.append(check_ln_backward(torch, ll, lnp, T_SORT, 85))
    # The segment sums at every layout above, and each side of the
    # one-pass kernel's crossover.
    seg = sum_cases(torch, ss, dict(
        exact=g_exact, bucket=g_bucket, sort=g_sort, sort_u=g_sort_u,
        large=g_large, samp=g_samp, cross_small=crossover_graph(torch, 16, 0),
        cross_large=crossover_graph(torch, 17, 1)))
    gather_add_sort = check_gather_add(torch, ga, g_sort_u, 88)
    checks = (edge_cases + ffn_cases + edge_h_cases
              + [c for cases in seg.values() for c in cases.values()]
              + gather_cases + ln_cases + lnm_cases
              + [gather_add_case, gather_add_samp, gather_add_sort]
              + g1_cases + ffn_bwd_cases + [rg_case])
    for c in checks:
        log("check: " + json.dumps(c))
    log_sums(seg, where)
    log_f32_ffn(ffn_f32_cases + ffn_bwd_f32_cases, where)
    log_f32_ffn([c for c in ln_cases if "f32" in c["shape"]], where,
                "LN->matmul backward")
    log_f32_ffn([c for c in g1_cases if "d=256 float32" in c["shape"]],
                where, "single-graph edge update")
    for c in ln_cases:
        if "pass_ms" in c:
            pm = c["pass_ms"]
            log(f"ln_linear_backward {c['shape']}: row pass "
                f"{pm['rows']:.4f} ms, dW pass {pm['dw']:.4f} ms, fused "
                f"reduction {pm['reduction']:.4f} ms (of {c['kernel_ms']:.4f} "
                f"ms; bound {c['bound_ms']:.4f} ms); {where}")
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
    train_expect = dict(edge=N_CORES, segment_sum=2 * N_CORES,
                        windowed=N_CORES, gather=N_CORES,
                        ln_backward=N_CORES)
    train = train_phase(torch, pt, g, train_expect, zero_counts,
                        read_counts, "train step")
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
        f"{sort['pure_busy_ms']:.4f} ms; the step captured as a CUDA graph "
        f"{sort['captured_step_ms']:.4f} ms, one profiled replay "
        f"{sort['replay_kernels']} kernels of "
        f"{sort['replay_busy_ms'] or 0:.4f} ms, busy share of a replay "
        f"{busy_share(sort['replay_busy_ms'], sort['captured_step_ms'])}; "
        f"forward {sort['fwd_ms']:.4f} ms "
        f"eager, {sort['fwd_graph_ms']:.4f} ms as a CUDA graph; {where}")
    for dev_ms, count, name in sort["prof_rows"][:25]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")

    # S. The sort flagship as the JAX package runs it by default.
    t_s = time.perf_counter()
    dsort = device_sort_phase(torch, pt, zero_counts, read_counts)
    log(f"device sort loop (train_sort_device, {S_CHUNKS} chunks of "
        f"{S_CHUNK} steps, f32, batches generated on the card): "
        f"{dsort['steps_per_sec']:.4f} steps/s against "
        f"{sort['steps_per_sec']:.4f} for phase A's host loop (train_sort); "
        f"the captured step (batch generation included) "
        f"{dsort['captured_step_ms']:.4f} ms a replay, eager "
        f"{dsort['eager_step_ms']:.4f} ms, {dsort['kernels_per_step']} "
        f"kernels of {dsort['busy_ms']:.4f} ms in one profiled eager step, "
        f"{dsort['replay_kernels']} of {dsort['replay_busy_ms'] or 0:.4f} ms "
        f"in one profiled replay, busy share of a replay "
        f"{busy_share(dsort['replay_busy_ms'], dsort['captured_step_ms'])}; "
        f"metrics of the last chunk {dsort['metrics']}; phase S took "
        f"{time.perf_counter() - t_s:.1f} s; {where}")
    for dev_ms, count, name in dsort["prof_rows"][:10]:
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

    # C. The single large graph: forward and train step.
    lfwd = large_forward_phase(torch, pt, g_large, zero_counts, read_counts)
    log(f"large-graph forward (N={LG_N} E={LG_E} D={LG_D}, {LG_CORES} "
        f"cores, bf16): {lfwd['fwd_ms']:.4f} ms eager "
        f"({LG_E / lfwd['fwd_ms'] * 1e3:.4e} edges/s), "
        f"{lfwd['fwd_graph_ms']:.4f} ms as a CUDA graph, kernel route; pure "
        f"route {lfwd['pure_ms']:.4f} ms eager; profile of one forward: "
        f"{sum(r[1] for r in lfwd['prof_rows'])} kernels, "
        f"{lfwd['busy_ms']:.4f} ms of {lfwd['wall_ms']:.4f} ms wall; {where}")
    for dev_ms, count, name in lfwd["prof_rows"][:10]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    ltrain = large_train_phase(torch, pt, g_large, zero_counts, read_counts)
    log(f"large-graph train step vs its f32 twin: loss {ltrain['loss']:.6f} "
        f"vs {ltrain['f32_loss']:.6f} (pure bf16 route "
        f"{ltrain['pure_loss']:.6f}; tolerance: the larger of 1e-2 relative "
        f"and {G1_F32_SLACK} x the pure bf16 route's distance from f32); "
        f"worst gradient {ltrain['worst_grad'][1]} at "
        f"{ltrain['worst_grad'][0]:.4f} of its bound (2-norms: max of 5e-2 "
        f"x the twin's and {G1_F32_SLACK} x that distance); by the largest "
        f"element at most {ltrain['worst_grad_top'][0]:.4f} x the pure "
        f"route's distance; under phase 4b's rule against the pure bf16 "
        f"route: {ltrain['worst_grad_4b'][0]:.4f}; losses "
        f"{ltrain['losses']}")
    log(f"large-graph train step: {ltrain['step_ms']:.4f} ms eager "
        f"({LG_E / ltrain['step_ms'] * 1e3:.4e} edges/s), kernel route; "
        f"with the fused edge->node sum off under training "
        f"{ltrain['off_step_ms']:.4f} ms; pure route forward and backward "
        f"under per-core activation checkpointing, no optimizer, "
        f"{ltrain['pure_step_ms']:.4f} ms; profile of one step: "
        f"{sum(r[1] for r in ltrain['prof_rows'])} kernels, "
        f"{ltrain['busy_ms']:.4f} ms of {ltrain['wall_ms']:.4f} ms wall, "
        f"busy share {ltrain['busy_ms'] / ltrain['wall_ms']:.3f}; peak "
        f"device memory of the first step {ltrain['peak_gb']:.4f} GiB "
        f"({ltrain['own_gb']:.4f} its own); with every core under remat "
        f"{ltrain['remat_step_ms']:.4f} ms, peak "
        f"{ltrain['remat_peak_gb']:.4f} GiB ({ltrain['remat_own_gb']:.4f} "
        f"its own); {where}")
    for dev_ms, count, name in ltrain["prof_rows"][:15]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")
    del g_large

    # F. The JAX package's default precision: the headline forward and C's
    # forward and step in f32.
    fphase = f32_phase(torch, pt, zero_counts, read_counts, where)

    # D. Sampled training on the arxiv-shaped graph.
    samp = sampled_phase(torch, pt, zero_counts, read_counts, ax_graph,
                         ax_build_s)
    log(f"sampled training: {samp['step_ms']:.4f} ms a step on the device "
        f"path alone (batches sampled beforehand), "
        f"{samp['step_ms'] + samp['sample_ms']:.4f} ms with the host "
        f"sampler ({samp['sample_ms']:.4f} ms a batch, native, not "
        f"overlapped): {AX_BATCH / (samp['step_ms'] + samp['sample_ms']) * 1e3:.4e} "
        f"seeds/s; pure route {samp['pure_step_ms']:.4f} ms a step; losses "
        f"{samp['losses']}; profile of one step: "
        f"{sum(r[1] for r in samp['prof_rows'])} kernels, "
        f"{samp['busy_ms']:.4f} ms of {samp['wall_ms']:.4f} ms wall; {where}")
    for dev_ms, count, name in samp["prof_rows"][:12]:
        log(f"  {dev_ms:9.4f} ms  x{count:<4d} {name[:90]}")

    # E. Sampled training as the JAX package runs it: native sampler,
    # prefetch workers, the captured step.
    pipe = pipeline_phase(torch, pt, zero_counts, read_counts, ax_graph,
                          samp["first_launches"])
    chk = pipe["check"]
    log(f"sampled step captured as a CUDA graph: {chk['captured_ms']:.4f} ms "
        f"against {chk['eager_ms']:.4f} ms eager; one profiled replay "
        f"{chk['replay_kernels']} kernels of "
        f"{chk['replay_busy_ms'] or 0:.4f} ms, busy share "
        f"{busy_share(chk['replay_busy_ms'], chk['captured_ms'])}; {where}")
    log(f"sampled pipeline: {pipe['batches']} batches from {E_WORKERS} "
        f"prefetch workers (native sampler, pinned batches) into the "
        f"captured step: {pipe['pipe_ms']:.4f} ms a batch = "
        f"{AX_BATCH / pipe['pipe_ms'] * 1e3:.4e} seeds/s; the captured step "
        f"fed by an in-line native sampler {pipe['inline_ms']:.4f} ms = "
        f"{AX_BATCH / pipe['inline_ms'] * 1e3:.4e} seeds/s; phase D's eager "
        f"step with the in-line sampler "
        f"{samp['step_ms'] + samp['sample_ms']:.4f} ms = "
        f"{AX_BATCH / (samp['step_ms'] + samp['sample_ms']) * 1e3:.4e} "
        f"seeds/s; a replay alone {pipe['replay_ms']:.4f} ms, "
        f"{pipe['replay_ms'] / pipe['pipe_ms']:.3f} of the pipeline's time "
        f"a batch; "
        f"launches {pipe['launches']}; losses {pipe['losses']}; {where}")

    # R. random_gather through its entry point, against index_select.
    from graphnets_tpu_torch.ops.kernels.random_gather import random_gather
    gen = torch.Generator().manual_seed(70)
    table = torch.randn(LG_N, LG_D, generator=gen).to(bf).cuda()
    idx = torch.randint(0, LG_N, (LG_E,), generator=gen).to(
        torch.int32).cuda()
    zero_counts()
    rows = random_gather(table, idx)
    torch.cuda.synchronize()
    rg_launches = read_counts()
    want_counts(rg_launches, dict(random_gather=1), "random_gather")
    if not torch.equal(rows, table.index_select(0, idx.long())):
        raise SystemExit("random_gather disagrees with index_select")
    del rows, table, idx
    log(f"random_gather [{LG_N}, {LG_D}] bf16 -> {LG_E} rows: "
        f"{rg_case['kernel_ms']:.4f} ms "
        f"({rg_case['bytes'] / rg_case['kernel_ms'] / 1e6:.4f} GB/s), "
        f"index_select {rg_case['library_ms']:.4f} ms "
        f"({rg_case['bytes'] / rg_case['library_ms'] / 1e6:.4f} GB/s), "
        f"bound {rg_case['bound_ms']:.4f} ms; {where}")

    # P. Data, tensor and pipeline parallelism over torch.distributed.
    par = parallel_phase(torch, pt, train_expect, zero_counts, read_counts,
                         where)
    log(f"P(a) against phase 4b's captured step "
        f"{train['captured']['captured_ms']:.4f} ms: the captured DP step "
        f"{par['a']['captured_ms']} ms, the plain one here "
        f"{par['a']['plain_captured_ms']} ms; {where}")

    # G. Edge-partitioned graph parallelism.
    gpar = partitioned_phase(torch, pt, zero_counts, read_counts, where,
                             ltrain)

    # 5. Results.
    paths = {"forward": fwd["launches"], "train_step": train["launches"],
             "sort_train_step": sort["first_launches"],
             "sort_device_step": dsort["step_launches"],
             "sort_device_train": dsort["train_launches"],
             "sort_device_step_bf16": dsort["bf16_launches"]["bf16"],
             "sort_device_step_bf16_uniform":
                 dsort["bf16_launches"]["bf16 uniform"],
             "bucketed_forward": bfwd["launches"],
             "bucketed_train_step": btrain["launches"],
             "large_forward": lfwd["launches"],
             "large_train_step": ltrain["launches"],
             "large_train_step_no_agg": ltrain["off_launches"],
             "sampled_train_step": samp["first_launches"],
             "train_step_captured": train["captured"]["launches"],
             "bucketed_train_step_captured": btrain["captured"]["launches"],
             "large_train_step_remat": ltrain["remat_launches"],
             "f32_forward": fphase["a"]["launches"],
             "f32_large_forward": fphase["b_forward"]["launches"],
             "f32_large_train_step": fphase["b_train"]["launches"],
             "f32_large_train_step_captured":
                 fphase["b_train"]["captured_launches"],
             "sampled_pipeline": pipe["launches"],
             "random_gather": rg_launches, **par["launches"],
             **gpar["launches"]}
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
                     [seg[k]["sorted"] for k in (
                         "exact", "bucket", "bucket32", "large", "samp",
                         "sort_u", "sort_u32", "cross_small",
                         "cross_large")]),
        kernel_entry("windowed_segment_sum", src + "segment_sum.cu",
                     ref + "segment_sum.py:193", by_path("windowed"),
                     [seg[k]["windowed"] for k in (
                         "exact", "bucket", "bucket32", "sort32", "sort_u",
                         "sort_u32", "cross_small", "cross_large")]),
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
                     [gather_add_case, gather_add_samp, gather_add_sort]),
        kernel_entry("fused_g1_edge_update_agg", src + "edge_update_g1.cu",
                     ref + "edge_update_g1.py:338", by_path("edge_g1_agg"),
                     g1_agg_cases),
        kernel_entry("fused_g1_edge_update", src + "edge_update_g1.cu",
                     ref + "edge_update_g1.py:338", by_path("edge_g1"),
                     g1_h_cases),
        kernel_entry("ln_ffn_backward", src + "fused_ffn_bwd.cu",
                     ref + "fused_ffn.py:240", by_path("ffn_backward"),
                     ffn_bwd_cases),
        kernel_entry("random_gather", src + "random_gather.cu",
                     ref + "random_gather.py:99", by_path("random_gather"),
                     [rg_case]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise SystemExit(f"kernels launched on no path: {idle}")
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
                    "sort": slim(sort), "sort_device": slim(dsort),
                    "bucketed_forward": slim(bfwd),
                    "bucketed_train_step": slim(btrain),
                    "large_forward": slim(lfwd),
                    "large_train_step": slim(ltrain), "f32": fphase,
                    "sampled_train": slim(samp),
                    "sampled_pipeline": pipe,
                    "parallel": {k: v for k, v in par.items()
                                 if k != "launches"},
                    "partitioned": {k: v for k, v in gpar.items()
                                    if k != "launches"},
                    "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

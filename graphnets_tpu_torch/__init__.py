"""graphnets_tpu_torch: the PyTorch / CUDA port of ``graphnets_tpu``.

It runs on an NVIDIA GPU by default (pass ``device="cpu"`` for the CPU) and
holds hand-written Hopper kernels for its hot paths (``ops/kernels``,
sources in ``csrc/``).  It imports neither JAX nor ``graphnets_tpu``; the
JAX package is the reference it is tested against.

The port covers batching, the nn modules, the scatter primitives, GNBlock
and GNCore/GNCoreList, their forward on uniform batches and their training
step (``make_train_step``: the masked losses, the backward through the
kernels' own backward kernels, AdamW), with f32 master parameters and bf16
compute on the kernel routes; the non-uniform route (``PadSpec.bucketed``
batches through ``ln_matmul`` and ``sorted_gather_add``); and the sort
task: ``EncodeProcessDecode``, the host data generator, ``train_sort`` and
``sort_accuracy``; and the single large graph (G = 1): the one-pass
single-graph edge update with its edge->node sum, training through the
fused LN->FFN->residual kernel's own backward, the host neighbour sampler
(``LargeGraph``, ``NeighborSampler``) and the node-classification step;
and sampled training as the JAX package runs it: the native C++ runtime
(``runtime/``), prefetch threads, the OGB loader, ``remat`` and the training
step captured as a CUDA graph (``capture_step``, the counterpart of
``jax.jit``); and the sort flagship as the JAX package runs it by default:
batches generated on the device (``device_batch``) inside the captured
step, ``train_sort_device`` and ``evaluate_sort``, checkpoints
(``CheckpointManager``), the SVG renderings, the debug checks
(``validate_graph``, ``GRAPHNETS_TPU_TORCH_DEBUG``), the views and edge
collapsing of ``graph``, ``segment_mean`` / ``segment_max``, the precision
policy, metrics and profiling helpers (spans and device phase markers
under ``GRAPHNETS_TPU_TORCH_TRACE=1``); and learning-rate schedules
(``training/schedules``) and parallel training over ``torch.distributed``
(``parallel/``: meshes, the multi-process runtime, data, tensor and
pipeline parallelism); and GraphCast (``models/graphcast``) on a typed
graph of the grid and the icosahedral multi-mesh (``typed_graph``,
``data/graphcast_mesh``), trained on the latitude-weighted MSE.
"""

from .data.graphcast_mesh import (GraphCastGraph, batch_samples,
                                  build_graphcast_graph)
from .data.large_graph import (LargeGraph, NeighborSampler, SampledBatch,
                               csc_from_coo, device_feature_table)
from .data.ogb import (OGBNodeDataset, load_ogb_node_dataset,
                       save_ogb_node_dataset)
from .data.prefetch import PrefetchIterator, PrefetchPool, prefetch
from .data.sort_task import (SortTaskConfig, device_batch, gen_sample,
                             get_batch, sort_draws, sort_layout,
                             sort_pad_spec)
from .graph import (
    GNGraphBatch,
    GraphsTuple,
    PadSpec,
    adjacency_matrices,
    batch,
    collapse_ef,
    collapse_ef_padded,
    collapsef,
    efview,
    flat_unpadded_collapsed_ef,
    flat_unpadded_ef,
    flat_unpadded_nf,
    flatunpaddedcollapsedef,
    flatunpaddedef,
    flatunpaddednf,
    gfview,
    nfview,
    unbatch,
    unpadded_collapsed_ef,
    unpaddedcollapsedef,
)
from .models.encode_process_decode import EncodeProcessDecode, GNModel
from .models.graphcast import GraphCast, InteractionNetwork, SwishMLP
from .models.gn_block import (
    GNBlock,
    get_edge_fn_input,
    get_graph_fn_input,
    get_node_fn_input,
    getedgefninput,
    getgraphfninput,
    getnodefninput,
    zerodim2nothing,
)
from .models.gn_core import (
    GNCore,
    GNCoreList,
    GNFeedForward,
    GNGraphNorm,
    graphnet_add,
)
from .nn.core import Chain, Dropout, FeedForward, LayerNorm, Linear, relu
from .nn.precision import (BF16_COMPUTE, DEFAULT, Policy, cast_features,
                           cast_params)
from .ops.scatter import segment_mean, segment_max, segment_sum
from .params import from_jax_params, to_numpy_tree
from .training.checkpoint import (CheckpointManager, restore_checkpoint,
                                  save_checkpoint)
from .training.losses import (graph_accuracy, graph_loss_nf_ef,
                              graphcast_latitude_weights,
                              latitude_weighted_mse, masked_accuracy,
                              masked_logit_crossentropy, per_graph_correct)
from .training.evaluate import sort_accuracy
from .training.schedules import (constant_schedule,
                                 warmup_cosine_decay_schedule)
from .training.train import (CapturedStep, SortTrainResult, TrainState,
                             adam, adamw, capture_step, evaluate_sort,
                             make_node_classification_step,
                             make_sort_device_step, make_train_step,
                             train_sort, train_sort_device)
from .typed_graph import EdgeSet, TypedGraph
from .util import get_edge_features, get_graph_features, get_node_features
from .utils.config import (debug_checks, enable_debug_checks,
                           enable_kernels, enable_tracing, tracing,
                           use_kernels)
from .utils.debug import assert_finite, checked, validate_graph
from .utils.metrics import MetricLogger, host0_logger, is_host0
from .utils.profiling import StepTimer, annotate, trace
from .utils.viz import render_graph_svg, sort_input_svg, sort_target_svg

__version__ = "0.1.0"

__all__ = [
    "GraphsTuple", "PadSpec", "batch", "unbatch", "adjacency_matrices",
    "efview", "nfview", "gfview",
    "flat_unpadded_nf", "flat_unpadded_ef",
    "flatunpaddednf", "flatunpaddedef",
    "collapse_ef", "collapse_ef_padded", "collapsef", "unpadded_collapsed_ef",
    "flat_unpadded_collapsed_ef", "GNGraphBatch", "unpaddedcollapsedef",
    "flatunpaddedcollapsedef",
    "GNBlock", "get_edge_fn_input", "get_node_fn_input",
    "get_graph_fn_input", "getedgefninput", "getnodefninput",
    "getgraphfninput", "zerodim2nothing",
    "GNCore", "GNCoreList", "GNFeedForward", "GNGraphNorm", "graphnet_add",
    "Chain", "Dropout", "FeedForward", "LayerNorm", "Linear", "relu",
    "from_jax_params", "to_numpy_tree", "enable_kernels", "use_kernels",
    "masked_logit_crossentropy", "graph_loss_nf_ef", "masked_accuracy",
    "per_graph_correct", "graph_accuracy", "adamw", "make_train_step",
    "EncodeProcessDecode", "GNModel", "SortTaskConfig", "gen_sample",
    "get_batch", "sort_pad_spec", "train_sort", "SortTrainResult",
    "sort_accuracy", "LargeGraph", "NeighborSampler", "SampledBatch",
    "csc_from_coo", "device_feature_table", "make_node_classification_step",
    "adam", "capture_step", "CapturedStep", "OGBNodeDataset",
    "load_ogb_node_dataset", "save_ogb_node_dataset", "prefetch",
    "PrefetchIterator", "PrefetchPool",
    "device_batch", "sort_draws", "sort_layout", "TrainState",
    "make_sort_device_step", "train_sort_device", "evaluate_sort",
    "CheckpointManager", "save_checkpoint", "restore_checkpoint",
    "segment_sum", "segment_mean", "segment_max",
    "Policy", "DEFAULT", "BF16_COMPUTE", "cast_features", "cast_params",
    "get_edge_features", "get_node_features", "get_graph_features",
    "debug_checks", "enable_debug_checks", "tracing", "enable_tracing",
    "validate_graph",
    "assert_finite", "checked", "MetricLogger", "host0_logger", "is_host0",
    "trace", "annotate", "StepTimer", "render_graph_svg", "sort_input_svg",
    "sort_target_svg", "constant_schedule", "warmup_cosine_decay_schedule",
    "TypedGraph", "EdgeSet", "GraphCastGraph", "build_graphcast_graph",
    "batch_samples", "GraphCast", "InteractionNetwork", "SwishMLP",
    "latitude_weighted_mse", "graphcast_latitude_weights",
]

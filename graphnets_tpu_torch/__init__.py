"""graphnets_tpu_torch: the PyTorch / CUDA port of ``graphnets_tpu``.

It runs on an NVIDIA GPU by default (pass ``device="cpu"`` for the CPU) and
holds hand-written Hopper kernels for its hot paths (``ops/kernels``,
sources in ``csrc/``).  It imports neither JAX nor ``graphnets_tpu``; the
JAX package is the reference it is tested against.

The port covers batching, the nn modules, the scatter primitives, GNBlock
and GNCore/GNCoreList, their forward on uniform batches and their training
step (``make_train_step``: the masked losses, the backward through the
kernels' own backward kernels, AdamW), with f32 master parameters and bf16
compute on the kernel routes.
"""

from .graph import GraphsTuple, PadSpec, adjacency_matrices, batch, unbatch
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
from .params import from_jax_params, to_numpy_tree
from .training.losses import (graph_accuracy, graph_loss_nf_ef,
                              masked_accuracy, masked_logit_crossentropy,
                              per_graph_correct)
from .training.train import adamw, make_train_step
from .utils.config import enable_kernels, use_kernels

__version__ = "0.1.0"

__all__ = [
    "GraphsTuple", "PadSpec", "batch", "unbatch", "adjacency_matrices",
    "GNBlock", "get_edge_fn_input", "get_node_fn_input",
    "get_graph_fn_input", "getedgefninput", "getnodefninput",
    "getgraphfninput", "zerodim2nothing",
    "GNCore", "GNCoreList", "GNFeedForward", "GNGraphNorm", "graphnet_add",
    "Chain", "Dropout", "FeedForward", "LayerNorm", "Linear", "relu",
    "from_jax_params", "to_numpy_tree", "enable_kernels", "use_kernels",
    "masked_logit_crossentropy", "graph_loss_nf_ef", "masked_accuracy",
    "per_graph_correct", "graph_accuracy", "adamw", "make_train_step",
]

"""Parallel training over ``torch.distributed`` (counterpart of
``graphnets_tpu/parallel``): device meshes, the multi-process runtime,
data, tensor and pipeline parallelism, and edge-partitioned graph
parallelism (one graph over a mesh axis).  The modules keep the JAX
package's ``__all__``, with the port's additions."""

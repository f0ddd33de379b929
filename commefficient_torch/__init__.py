"""PyTorch/CUDA port of CommEfficient-TPU.

The JAX package beside it is the frozen reference; this
package runs the same federated rounds with PyTorch on an NVIDIA H100,
and its tests hold it against the reference on identical inputs. It never
imports JAX or the JAX package.
"""

"""The port's mesh (counterpart of the JAX package's ``parallel/``):
``init_distributed``, ``make_mesh``, ``FedShardings``, ring attention over
the seq axis (``ring``) and the tests' CPU rank groups
(``spawn_ranks``)."""

from commefficient_torch.parallel.mesh import (AXIS, SEQ, FedShardings,
                                               Mesh, init_distributed,
                                               make_mesh, spawn_ranks)

__all__ = ["AXIS", "SEQ", "FedShardings", "Mesh", "init_distributed",
           "make_mesh", "spawn_ranks"]

"""The port's clients mesh (counterpart of the JAX package's
``parallel/``): ``init_distributed``, ``make_mesh``, ``FedShardings`` and
the tests' CPU rank groups (``spawn_ranks``)."""

from commefficient_torch.parallel.mesh import (AXIS, NEXT_SLICE,
                                               FedShardings, Mesh,
                                               init_distributed, make_mesh,
                                               spawn_ranks)

__all__ = ["AXIS", "NEXT_SLICE", "FedShardings", "Mesh", "init_distributed",
           "make_mesh", "spawn_ranks"]

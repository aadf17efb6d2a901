"""Distributed execution: the port of ``ndstpu.parallel``.

The JAX package distributes a query over a device mesh with XLA
collectives inside ``shard_map`` programs.  The port's mesh is a rank
count (:mod:`.mesh`): the world size of an initialized
``torch.distributed`` group, or 1.  Over one rank the distributed plan
executor (:mod:`.dplan`) is the single-card out-of-core path: it streams a
fact from host memory through the card in chunks.  It refuses a larger
mesh; the multi-rank path and its collectives over NCCL are a later
slice.
"""

from ndstpu_torch.parallel.mesh import default_mesh, make_mesh  # noqa: F401

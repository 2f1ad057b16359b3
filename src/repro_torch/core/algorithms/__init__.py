"""Collective algorithm schedule builders (the MPIX algorithm zoo).

Every builder takes a ``Topology`` and returns a ``Schedule`` executable by
any ``Transport``.  Registries map (collective, algorithm-name) to builder,
mirroring MPI Advance's publicly-selectable algorithm tables.
"""
from repro_torch.core.algorithms import (allgather, allreduce, alltoall,
                                         partitioned, reduce_scatter, staged)

# "staged" (hierarchy-staged through every Topology level; staged.py) is
# merged here rather than into each family's ALGORITHMS dict because
# staged.py imports the families' sub-stage builders.  It must stay
# AFTER the family entries: modeled-time ties (staged == hierarchical on
# 2-level topologies) resolve to the earlier registration.
REGISTRY = {
    coll: {**algos.ALGORITHMS, "staged": staged.ALGORITHMS[coll]}
    for coll, algos in (("allgather", allgather), ("allreduce", allreduce),
                        ("reduce_scatter", reduce_scatter),
                        ("alltoall", alltoall))
}
# chunked point-to-point transfers (MPIPCL partition-count choice);
# timed by the tuner like any CommSchedule, not exposed via mpix_*.
REGISTRY["partitioned"] = partitioned.ALGORITHMS

# Collectives with an mpix_* API entry point (the dense families).
DENSE_COLLECTIVES = ("allgather", "allreduce", "reduce_scatter", "alltoall")

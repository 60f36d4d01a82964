"""Multi-chip parallelism: row-sharded implicit matvec over a device mesh.

JAX replacement for the reference's feature-split multi-GPU scheme and
host-staged ``device_reduction`` all-reduce (``gpu_csvm.cpp:130-157,366-386``)
with ``shard_map`` + ``psum``/collectives over ICI/DCN (SURVEY.md §2.4).
"""

"""The device's roofline ceilings (the analytic spec table and its
calibration on the card) and the rank mesh of the distributed path."""

from .mesh import Mesh, make_production_mesh, make_test_mesh, spawn_ranks
from .roofline import (
    BACKEND_SPECS,
    H100_DATASHEET,
    H100_DATASHEET_SFU_S,
    HardwareSpec,
    Roofline,
    analyze,
    backend_spec,
)
from .sharding import P, PartitionSpec, gather_shards, local_shard

__all__ = ["BACKEND_SPECS", "H100_DATASHEET", "H100_DATASHEET_SFU_S", "HardwareSpec", "Mesh", "P",
           "PartitionSpec", "Roofline", "analyze", "backend_spec", "gather_shards", "local_shard",
           "make_production_mesh", "make_test_mesh", "spawn_ranks"]

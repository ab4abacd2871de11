"""PEMS2 core of the PyTorch port: contexts, the superstep executor and the
collectives, on the device tier (over ``P`` real processors of a one-device
mesh) and on the host, memmap and file backing tiers (sharded at ``P > 1``).

Public API::

    from repro_torch.core import (
        Pems, PemsConfig, ContextLayout, ContextStore, Ctx, Field,
        Allocator, IOLedger, TierStats, Mesh, make_mesh,
        TieredStore, make_backing, HostBacking, MemmapBacking, FileBacking,
        ShardedBacking,
    )
"""

from .context import (
    WORD,
    Allocator,
    ContextLayout,
    ContextStore,
    Ctx,
    Field,
    init_store,
    resolve_device,
)
from .backing import (
    TIERS,
    FileBacking,
    HostBacking,
    MemmapBacking,
    ShardedBacking,
    TieredStore,
    make_backing,
)
from .executor import DRIVERS, Pems, PemsConfig
from .iostats import IOLedger, TierStats
from .mesh import Mesh, make_mesh

__all__ = [
    "Allocator",
    "ContextLayout",
    "ContextStore",
    "Ctx",
    "DRIVERS",
    "Field",
    "FileBacking",
    "HostBacking",
    "IOLedger",
    "MemmapBacking",
    "Mesh",
    "Pems",
    "PemsConfig",
    "ShardedBacking",
    "TIERS",
    "TierStats",
    "TieredStore",
    "WORD",
    "init_store",
    "make_backing",
    "make_mesh",
    "resolve_device",
]

"""PEMS2 core of the PyTorch port: contexts, the superstep executor and the
collectives, on the device tier (over ``P`` real processors of a one-device
mesh) and on the host, memmap and file backing tiers (sharded at ``P > 1``).

Public API::

    from repro_torch.core import (
        Pems, PemsConfig, ContextLayout, ContextStore, Ctx, Field,
        Allocator, IOLedger, TierStats, Mesh, make_mesh,
        TieredStore, make_backing, HostBacking, MemmapBacking, FileBacking,
        ShardedBacking, SuperstepCursor, atomic_replace_file,
        atomic_write_json,
    )
"""

from . import analysis
from .context import (
    WORD,
    Allocator,
    ContextLayout,
    ContextStore,
    Ctx,
    Field,
    init_store,
    layout,
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
from .recovery import SuperstepCursor, atomic_replace_file, atomic_write_json

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
    "SuperstepCursor",
    "TIERS",
    "TierStats",
    "TieredStore",
    "WORD",
    "analysis",
    "atomic_replace_file",
    "atomic_write_json",
    "init_store",
    "layout",
    "make_backing",
    "make_mesh",
    "resolve_device",
]

"""PEMS2 core of the PyTorch port: contexts, the superstep executor and the
collectives, on the device tier, over ``P`` real processors of a one-device
mesh.

Public API::

    from repro_torch.core import (
        Pems, PemsConfig, ContextLayout, ContextStore, Ctx, Field,
        Allocator, IOLedger, Mesh, make_mesh,
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
from .executor import DRIVERS, TIERS, Pems, PemsConfig
from .iostats import IOLedger, TierStats
from .mesh import Mesh, make_mesh

__all__ = [
    "Allocator",
    "ContextLayout",
    "ContextStore",
    "Ctx",
    "DRIVERS",
    "Field",
    "IOLedger",
    "Mesh",
    "Pems",
    "PemsConfig",
    "TIERS",
    "TierStats",
    "WORD",
    "init_store",
    "make_mesh",
    "resolve_device",
]

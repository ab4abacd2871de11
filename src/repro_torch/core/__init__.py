"""PEMS2 core of the PyTorch port: contexts, the superstep executor and the
collectives, on the device tier at ``P == 1``.

Public API::

    from repro_torch.core import (
        Pems, PemsConfig, ContextLayout, ContextStore, Ctx, Field,
        Allocator, IOLedger,
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

__all__ = [
    "Allocator",
    "ContextLayout",
    "ContextStore",
    "Ctx",
    "DRIVERS",
    "Field",
    "IOLedger",
    "Pems",
    "PemsConfig",
    "TIERS",
    "TierStats",
    "WORD",
    "init_store",
    "resolve_device",
]

"""Public wrappers for the direct-delivery kernels (``ops.py:33-171`` of the
JAX package).

The kernel route is the default: :func:`deliver_tiles` and
:func:`assemble_proc_tiles` launch their CUDA kernels on a CUDA tensor and
run their plain versions on a CPU tensor, for payloads and counts payloads
of any dtype of 1, 2 or 4 bytes.
``use_kernel=False`` takes the dense reference (:mod:`.ref`) instead — the
seed implementation, kept so equivalence can be asserted end to end.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .alltoallv_deliver import assemble_proc_tiles, deliver_tiles


def check_fill_range(fill, dtype) -> None:
    """Reject a ``fill`` value the payload dtype cannot represent.

    A cast of an out-of-range integer wraps silently — a ``fill=INT_MAX``
    boundary sentinel on a narrower payload would corrupt every masked lane.
    Checked here, once, for every delivery path."""
    dt = (dtype if isinstance(dtype, torch.dtype)
          else getattr(torch, np.dtype(dtype).name))
    if not isinstance(fill, (int, float, np.integer, np.floating)):
        return                                 # not a plain number: can't check
    if dt == torch.bool:
        return                                 # neither integer nor float in JAX
    if not dt.is_floating_point:
        info = torch.iinfo(dt)
        if (isinstance(fill, (float, np.floating))
                and not float(fill).is_integer()):
            raise ValueError(
                f"fill={fill!r} is not representable in integer payload "
                f"dtype {_name(dt)}"
            )
        if not info.min <= int(fill) <= info.max:
            raise ValueError(
                f"fill={fill!r} out of range for payload dtype {_name(dt)} "
                f"[{info.min}, {info.max}]: the cast would wrap silently"
            )
    else:
        try:
            f = float(fill)
        except OverflowError:
            raise ValueError(
                f"fill={fill!r} overflows payload dtype {_name(dt)}"
            ) from None
        fmax = float(torch.finfo(dt).max)
        if math.isfinite(f) and abs(f) > fmax:
            raise ValueError(
                f"fill={fill!r} overflows payload dtype {_name(dt)} "
                f"(max {fmax:g}): the cast would produce inf"
            )


def _name(dt: torch.dtype) -> str:
    return str(dt).rsplit(".", 1)[-1]


def _dispatch(msgs, counts, counts_payload, *, fill, use_kernel):
    if use_kernel:
        return deliver_tiles(msgs, counts, counts_payload, fill=fill)
    from .ref import deliver_fused_ref
    return deliver_fused_ref(msgs, counts, counts_payload, fill=fill)


def deliver(msgs: torch.Tensor, counts: torch.Tensor, *, fill=0,
            use_kernel: bool = True) -> torch.Tensor:
    """PEMS2 direct delivery of ``msgs [v, v, ω]`` with valid lengths
    ``counts [v, v]`` → ``[v(dst), v(src), ω]``, lanes past the count set to
    ``fill``."""
    check_fill_range(fill, msgs.dtype)
    out, _ = _dispatch(msgs, counts.to(torch.int32), None, fill=fill,
                       use_kernel=use_kernel)
    return out


def deliver_fused(
    msgs: torch.Tensor,                        # [v, v, ω] (1, 2 or 4 bytes)
    counts: Optional[torch.Tensor] = None,     # [v, v] int32 mask lengths
    counts_payload: Optional[torch.Tensor] = None,  # [v, v] raw counts words
    *,
    fill=None,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Delivery with the optional fusions the collective layer uses: the
    boundary mask only when ``fill`` is given, and the counts transpose as a
    second output of the same kernel launch.  Returns ``(out, ct)``."""
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    if fill is not None:
        check_fill_range(fill, msgs.dtype)
    return _dispatch(
        msgs, None if fill is None else counts.to(torch.int32),
        counts_payload, fill=fill, use_kernel=use_kernel)


def assemble_proc_fused(
    msgs: torch.Tensor,                        # [s, P, d, ω] (1, 2 or 4 bytes)
    counts: Optional[torch.Tensor] = None,     # [s, P, d] int32 mask lengths
    counts_payload: Optional[torch.Tensor] = None,  # [s, P, d] raw counts words
    *,
    fill=None,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mesh-path staging with the same fusions as :func:`deliver_fused`: the
    chunk ``[s, P, d, ω]`` in destination order, ``out[p, d, j] = msgs[j,
    p, d]`` (boundary mask applied at the source; transposed counts payload
    as the fused second output).  Returns ``(out, ct)``."""
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    if fill is not None:
        check_fill_range(fill, msgs.dtype)
    counts = None if fill is None else counts.to(torch.int32)
    if use_kernel:
        return assemble_proc_tiles(msgs, counts, counts_payload, fill=fill)
    from .ref import assemble_proc_ref
    return assemble_proc_ref(msgs, counts, counts_payload, fill=fill)

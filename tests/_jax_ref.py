"""JAX reference runner for the PyTorch port's parity tests.

The port (``repro_torch``) is held against the JAX package (``repro``) on
the same inputs.  This helper imports the JAX package the way those tests
need it and hands results back as numpy arrays.

Under jax 0.9 ``batching.primitive_batchers`` is a ``PrimitiveBatchersProxy``
without ``__contains__``, so the membership test at
``repro/kernels/kway_merge/ops.py:66`` raises ``TypeError`` and
``repro.pems_apps`` cannot be imported.  :func:`_shim` gives the proxy the
missing ``__contains__`` (membership in ``fancy_primitive_batchers``, where
jax 0.9 registers the rule that test looks for) before anything imports the
JAX package's apps.  Nothing under ``src/repro`` changes.

The JAX package's ``P > 1`` paths need two more shims under jax 0.9, both
for a process that started with several host devices
(``--xla_force_host_platform_device_count``, set before jax starts):
:func:`auto_mesh` builds the mesh with an ``Auto`` axis (``jax.make_mesh``
now defaults to ``Explicit``, under which ``bcast``'s dynamic slice and the
mesh Alltoallv's landing raise ``ShardingTypeError``), and
:func:`enable_mesh` turns off ``shard_map``'s varying-axes check, which
rejects the rounds' ``scan`` carry (``uint32[3]`` against
``uint32[3]{V:vp}``).
"""

from __future__ import annotations

import numpy as np
from jax.interpreters import batching


def _shim() -> None:
    proxy = type(batching.primitive_batchers)
    if getattr(proxy, "__contains__", None) is None:
        proxy.__contains__ = (
            lambda self, p: p in batching.fancy_primitive_batchers)


_shim()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as core  # noqa: E402
import repro.kernels.alltoallv_deliver as deliver  # noqa: E402
import importlib  # noqa: E402

import repro.kernels.bitonic_sort.ops as bitonic_ops  # noqa: E402
import repro.kernels.kway_merge as kway  # noqa: E402
import repro.pems_apps as apps  # noqa: E402

# By name: the package re-exports a function of the module's own name.
bitonic = importlib.import_module("repro.kernels.bitonic_sort.bitonic_sort")

__all__ = ["apps", "auto_mesh", "bitonic", "bitonic_ops", "core", "deliver",
           "enable_mesh", "jax", "jnp", "kway", "np_out", "psrs",
           "psrs_plan_run", "store_words"]


def np_out(x):
    """A JAX result (array, tuple of arrays or ``None``) as numpy."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(np_out(e) for e in x)
    return np.asarray(x)


def store_words(store) -> np.ndarray:
    """The JAX store's ``[v, words]`` uint32 words."""
    return np.asarray(store.data)


def psrs(keys: np.ndarray, **kw):
    """``repro.pems_apps.psrs_sort`` → ``(sorted keys, ledger snapshot)``."""
    out, pems = apps.psrs_sort(keys, return_pems=True, **kw)
    return np.asarray(out), pems.ledger.snapshot()


def psrs_plan_run(keys: np.ndarray, v: int, upto: str, **kw):
    """Run the JAX ``psrs_plan`` stages in order through stage ``upto``;
    returns ``(pems, store)``."""
    n_v = keys.shape[0] // v
    pems, load, steps, _ = apps.psrs_plan(v, n_v, **kw)
    store = load(jnp.asarray(keys.reshape(v, n_v)))
    for name, step in steps:
        store = step(store)
        if name == upto:
            return pems, store
    raise ValueError(f"no stage {upto!r}")


def auto_mesh(P: int):
    """A ``P``-device mesh over the ``vp`` axis with an ``Auto`` axis type,
    the sharding the JAX package's ``P > 1`` code was written for."""
    return jax.make_mesh((P,), ("vp",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def enable_mesh() -> None:
    """Run the JAX package's ``shard_map`` calls with ``check_vma=False``.
    Its executor and collectives fetch ``shard_map`` through
    ``repro.core.executor._shard_map`` at call time, so wrapping that one
    module attribute covers every ``P > 1`` path."""
    import functools

    import repro.core.executor as executor

    shard_map = executor._shard_map()
    executor._shard_map = lambda: functools.partial(shard_map,
                                                    check_vma=False)

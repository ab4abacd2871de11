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

__all__ = ["apps", "bitonic", "bitonic_ops", "core", "deliver", "jax",
           "jnp", "kway", "np_out", "psrs", "psrs_plan_run", "store_words"]


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

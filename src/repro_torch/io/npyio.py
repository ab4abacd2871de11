"""Durable ``.npy`` file primitives of the checkpoint layer (the port's copy
of the JAX package's ``io/npyio.py``).

The checkpoint manager stages arrays as ``.npy`` files, chunk-CRC'd by its
manifest (:mod:`repro_torch.checkpoint.manager`).  The raw byte-level
operations behind that (binary ``open``, ``np.lib.format.open_memmap``,
``mmap_mode`` loads, an fsync by path) live in
:mod:`repro_torch.core.backing`, the port's one home of raw file access;
this module gives them their JAX package names.  They move checkpoint bytes,
which are deliberately outside the ``IOLedger``: the ledger models the
algorithm's I/O, not snapshot traffic.
"""

from ..core.backing import (
    create_npy_memmap,
    fsync_file,
    load_npy_mmap,
    save_npy_durable,
)

__all__ = ["create_npy_memmap", "fsync_file", "load_npy_mmap",
           "save_npy_durable"]

"""PyTorch/CUDA port of the PEMS2 reproduction (``repro``).

Imports ``torch`` and numpy only — never ``jax`` and nothing of ``repro``.
The first slice runs PSRS (:func:`repro_torch.pems_apps.psrs_sort`) on the
device tier at ``P == 1``, with hand-written Hopper kernels for the bitonic
local sort, the Alltoallv direct delivery and the k-way merge tiles.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

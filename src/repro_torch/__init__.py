"""PyTorch/CUDA port of the PEMS2 reproduction (``repro``).

Imports ``torch`` and numpy only — never ``jax`` and nothing of ``repro``.
It runs PSRS (:func:`repro_torch.pems_apps.psrs_sort`) on the device tier,
at ``P == 1`` and over ``P`` real processors of a one-device mesh
(:func:`repro_torch.core.make_mesh`), with hand-written Hopper kernels for
the bitonic local sort, the Alltoallv direct delivery, the mesh staging and
the k-way merge tiles, and serves the
dense, ssm and hybrid LM families (:mod:`repro_torch.models`,
:mod:`repro_torch.serve`) with kernels for flash attention, the Mamba-2 SSD
scan and the RG-LRU scan.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

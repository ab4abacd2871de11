"""Euler tour of a rooted forest on PEMS (thesis §8.4.3, CGMLib app).

Pipeline (each EM-heavy stage is a PEMS program, composed exactly like the
CGMLib application composes its sort and list-ranking primitives):

  1. **PSRS sort** of (parent, child) keys → children of every node become
     contiguous, globally ordered (the doubled-edge adjacency of Fig 8.22).
  2. Decode first-child / next-sibling pointers (local index arithmetic).
  3. Build the Euler successor function over directed-edge IDs
     (down-edge of i = 2i, up-edge = 2i+1):
        succ(2i)   = 2·firstchild(i)          if i has children else 2i+1
        succ(2i+1) = 2·nextsibling(i)         if it exists
                   = terminal                 if parent(i) is a root
                   = 2·parent(i)+1            otherwise
  4. **List ranking** of succ → each edge's distance to its tour's end.

Returns per-edge ranks; ordering a tree's edges by descending rank yields the
Euler tour (Fig 8.23's visit order).  Steps 2-3 run on tensors on the
entry's device, between the two PEMS programs.
"""

from __future__ import annotations

import torch

from ..core import resolve_device
from .list_ranking import list_rank
from .psrs import psrs_sort


def euler_tour(parent, v: int, k: int = 1, driver: str = "explicit",
               mode: str = "direct", device=None):
    """Compute the Euler tour structure of a forest.

    Args:
      parent: [n] int array, ``parent[r] == r`` for roots; children are
        ordered by node index.
      device: where it runs, CUDA by default (PSRS's and list ranking's
        kernels launch there), ``"cpu"`` for the plain PyTorch paths.
    Returns:
      dict of tensors on ``device`` with ``succ`` ([2n] int64 edge successor
      ids), ``rank`` ([2n] int32 hops to tour end), ``valid`` ([2n] bool,
      False for root pseudo-edges), ``firstchild`` and ``nextsib`` ([n]
      int64, -1 for none) — the JAX package's keys and values.

    Raises ``ValueError`` past 46,340 nodes, where the packed (parent,
    child) keys leave 32 bits, as the JAX package does, and
    ``RuntimeError`` when CUDA is asked for and missing.
    """
    dev = resolve_device(device)
    parent = torch.as_tensor(parent).to(device=dev, dtype=torch.int64)
    n = parent.shape[0]
    nodes = torch.arange(n, device=dev)
    is_root = parent == nodes

    # ---- 1. sort (parent, child) pairs of real edges with PSRS ------------
    nonroot = nodes[~is_root]
    keys = parent[nonroot] * n + nonroot
    # Pad to a multiple of v with +inf-like keys (sorted to the end).
    pad = (-len(keys)) % v
    if len(keys) + pad == 0:
        pad = v
    big = n * n + torch.arange(pad, device=dev)
    keys_padded = torch.cat([keys, big])
    if int(keys_padded.max()) >= 2**31:
        # 64-bit keys: sort (parent, child) lexicographically in two 32-bit
        # passes would be needed; for the sizes exercised here pack fits.
        raise ValueError("n too large for packed 32-bit PSRS keys")
    sorted_keys = psrs_sort(keys_padded.to(torch.int32), v=v, k=k,
                            driver=driver, mode=mode, device=dev)
    sorted_keys = sorted_keys.to(torch.int64)[: len(keys)]

    # ---- 2. first-child / next-sibling (local index arithmetic) -----------
    sp = sorted_keys // n
    sc = sorted_keys % n
    firstchild = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nextsib = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if len(sc):
        first_mask = torch.ones(len(sc), dtype=torch.bool, device=dev)
        first_mask[1:] = sp[1:] != sp[:-1]
        firstchild[sp[first_mask]] = sc[first_mask]
        same = sp[1:] == sp[:-1]
        nextsib[sc[:-1][same]] = sc[1:][same]

    # ---- 3. edge successor function ---------------------------------------
    succ = torch.arange(2 * n, device=dev)           # default: self (terminal)
    down = 2 * nonroot
    up = down + 1
    fc = firstchild[nonroot]
    succ[down] = torch.where(fc >= 0, 2 * fc, up)
    ns = nextsib[nonroot]
    p = parent[nonroot]
    succ[up] = torch.where(ns >= 0, 2 * ns,
                           torch.where(is_root[p], up, 2 * p + 1))

    # ---- 4. list-rank the tour ---------------------------------------------
    pad2 = (-2 * n) % (2 * v)
    succ_padded = torch.cat(
        [succ, 2 * n + torch.arange(pad2, device=dev)]).to(torch.int32)
    rank = list_rank(succ_padded, v=v, k=k, driver=driver, mode=mode,
                     device=dev)[: 2 * n]

    valid = torch.zeros(2 * n, dtype=torch.bool, device=dev)
    valid[down] = True
    valid[up] = True
    return {"succ": succ, "rank": rank, "valid": valid,
            "firstchild": firstchild, "nextsib": nextsib}

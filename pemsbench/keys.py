"""The general job generator: a traffic mix's parameters to each job's size
and keys.

A mix is data (``traffic/<mix>.json``):

* ``divisors``: the jobs' sizes, the configuration's ``n`` divided by each.
  The jobs cycle through them, each cycle in an order drawn from the seed,
  so every seed sorts the same sizes and a seed changes the order and the
  keys, never the work.
* ``keys``: ``distribution`` names the module ``generators/<distribution>.py``
  that makes the keys; its other entries are that module's parameters.

Every job's keys come from ``--seed`` and the job's index alone, through a
generator of their own on the device that holds them, so a job's keys can be
made again after the window for the reference.  The warm-up's jobs are
numbered below 0, one for each distinct size.
"""

from __future__ import annotations

import hashlib
import importlib
import random

import torch


def job_seed(seed: int, job) -> int:
    """A 63-bit seed for job ``job`` (an index, or a tag) of a run seeded
    ``seed`` (any integer)."""
    h = hashlib.blake2b(f"pemsbench:{seed}:{job}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class Jobs:
    """Each job's size and keys under a traffic mix (see the module)."""

    def __init__(self, traffic: dict, config: dict, seed: int,
                 scale_n=None):
        n = int(config["n"]) if scale_n is None else scale_n
        self.sizes = [n // d for d in traffic["divisors"]]
        params = dict(traffic["keys"])
        self.make = importlib.import_module(
            f"pemsbench.generators.{params.pop('distribution')}").keys
        self.params = params
        self.seed = seed
        self.warm = sorted(set(self.sizes), reverse=True)

    def size(self, j: int) -> int:
        """Job ``j``'s number of keys; ``-1 - i`` is the warm-up's job of
        the ``i``-th largest size."""
        if j < 0:
            return self.warm[-1 - j]
        cycle, i = divmod(j, len(self.sizes))
        order = list(range(len(self.sizes)))
        random.Random(job_seed(self.seed, f"cycle:{cycle}")).shuffle(order)
        return self.sizes[order[i]]

    def keys(self, j: int, device) -> torch.Tensor:
        """Job ``j``'s keys on ``device``."""
        gen = torch.Generator(device=device).manual_seed(job_seed(self.seed, j))
        return self.make(self.size(j), gen, **self.params)

"""Oracle for the bitonic sort kernel."""

import torch


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise (or 1-D) ascending sort."""
    return torch.sort(x, dim=-1, stable=True).values

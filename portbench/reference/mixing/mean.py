"""Exact consensus: every worker gets the mean of the M workers' blocks,
the B -> infinity limit of gossip."""
import torch

from portbench.reference.mixing import by_matrix


def make(m: int, *, device, dtype):
    return by_matrix(torch.full((m, m), 1.0 / m, dtype=dtype, device=device))

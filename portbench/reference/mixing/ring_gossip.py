"""Gossip over a ring (paper §III): each round, each worker weighs itself
and its ``degree`` nearest neighbours on each side by 1/(2 degree + 1);
``rounds`` rounds a consensus, H = C^rounds."""
import torch

from portbench.reference.mixing import by_matrix


def matrix(m: int, rounds: int, degree: int) -> torch.Tensor:
    """H = C^rounds over ``m`` workers, float64 on the CPU."""
    if 2 * degree + 1 > m:
        raise ValueError(f"a ring of {m} has no {degree} distinct neighbours a side")
    c = torch.zeros((m, m), dtype=torch.float64)
    for i in range(m):
        for k in range(-degree, degree + 1):
            c[i, (i + k) % m] += 1.0 / (2 * degree + 1)
    return torch.linalg.matrix_power(c, rounds)


def make(m: int, *, device, dtype, rounds: int, degree: int):
    return by_matrix(matrix(m, rounds, degree).to(device=device, dtype=dtype))

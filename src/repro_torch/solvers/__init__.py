# Iterative workloads on top of the HBP SpMV/SpMM kernels: the algorithms
# whose inner loop IS a sparse matrix product, so the format's preprocessing
# cost (paper Fig. 7) amortizes across iterations.  Every solver dispatches
# through the LinearOperator abstraction (operator.py) and runs its loop in
# base.while_loop, which keeps the counter, the convergence flag and the
# state on the device and reads the flag on the host once per chunk of
# CHECK_EVERY iterations.
from .base import EigResult, SolveResult
from .bicgstab import bicgstab
from .cg import cg
from .chebyshev import chebyshev, estimate_spectrum
from .operator import LinearOperator, aslinearoperator
from .power import pagerank, power_iteration, transition_matrix
from .precond import block_jacobi, hash_group_blocks, jacobi

__all__ = [
    "SolveResult",
    "EigResult",
    "LinearOperator",
    "aslinearoperator",
    "cg",
    "bicgstab",
    "chebyshev",
    "estimate_spectrum",
    "power_iteration",
    "pagerank",
    "transition_matrix",
    "jacobi",
    "block_jacobi",
    "hash_group_blocks",
]

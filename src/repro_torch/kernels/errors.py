"""Typed contract errors for the port's kernel wrappers (port of
``repro.kernels.errors``).

A wrapper called with inputs its kernel does not take (a CPU tensor for
a CUDA kernel, a wrong dtype, shape or alignment) raises
:class:`KernelContractError`, which names the kernel and the offending
values, with the JAX package's message format.  It subclasses
``ValueError``.  Build and launch failures stay ``RuntimeError``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

#: (dimension name, dimension value, divisor name, divisor value)
Constraint = Tuple[str, int, str, int]


class KernelContractError(ValueError):
    """A kernel wrapper was called with inputs violating its contract."""

    def __init__(self, kernel: str, message: str, values: dict = None):
        self.kernel = kernel
        self.values = dict(values or {})
        detail = ""
        if self.values:
            detail = " (" + ", ".join(f"{k}={v}" for k, v in self.values.items()) + ")"
        super().__init__(f"{kernel}: {message}{detail}")


def require_divisible(kernel: str, constraints: Sequence[Constraint]) -> None:
    """Raise :class:`KernelContractError` listing every violated triple.

    Each constraint is ``(dim_name, dim_value, divisor_name, divisor)``
    requiring ``dim_value % divisor == 0``.  All violations are reported
    at once so a caller fixing padding sees the full contract.
    """
    bad = [(dn, dv, bn, bv) for dn, dv, bn, bv in constraints if bv <= 0 or dv % bv != 0]
    if bad:
        values = {}
        for dn, dv, bn, bv in bad:
            values[dn] = int(dv)
            values[bn] = int(bv)
        names = " and ".join(f"{dn} % {bn} != 0" for dn, dv, bn, bv in bad)
        raise KernelContractError(
            kernel,
            f"block divisibility violated: {names}; pad inputs to block "
            "multiples (see kernels/<name>/ops.py for the padding wrapper)",
            values,
        )

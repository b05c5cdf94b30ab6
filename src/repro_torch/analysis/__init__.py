"""Static invariant checker for the port's hot paths and kernel wrappers
(port of ``repro.analysis``).

Three passes, one CLI (``python -m repro_torch.analysis``):

* **lint** (RA0xx, :mod:`repro_torch.analysis.rules`) -- AST rules
  enforcing the hot-path contracts: no host sync or numpy inside the hot
  scopes (:data:`repro_torch.analysis.lint.HOT_SCOPES`, the port's
  counterparts of the JAX package's jit functions, and the stream), no
  PRNG key reuse, no Python branching on tensors, typed kernel
  preconditions;
* **contracts** (RA1xx, :mod:`repro_torch.analysis.contracts`) -- calls
  every CUDA kernel wrapper on good and contract-violating inputs: the
  kernel launches on a card and is recorded on the CPU, and every bad
  input must raise ``KernelContractError``;
* **trace** (RA2xx, :mod:`repro_torch.analysis.trace`) -- runs the entry
  points on tiny shapes under a ``TorchDispatchMode`` and reports op/shape
  drift between same-bucket calls and the host syncs of each call.

Findings carry the reference's rule ids, ``file:line`` anchors and JSON
keys; severity gates the exit code.  Inline suppression is the
reference's: ``# ra: ignore[RA001]``.
"""
from repro_torch.analysis.cli import main, run_analysis
from repro_torch.analysis.findings import Finding, Report, Severity

__all__ = ["main", "run_analysis", "Finding", "Report", "Severity"]

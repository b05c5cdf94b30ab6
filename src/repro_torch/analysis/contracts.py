"""Kernel contract checker: call every kernel wrapper on good and bad
inputs (port of ``repro.analysis.contracts``).

Each registered target is a CUDA wrapper (``*_cuda`` in a kernel's
``ops.py``, and ``tag_probe_cuda``): the function that checks a kernel's
inputs and then launches it through ``repro_torch.kernels._build.launch``.
The checker calls it once on representative inputs and once on each
declared contract-violating input, and reports per target:

* RA107 typed preconditions -- calling the wrapper with contract-
  violating inputs must raise :class:`KernelContractError`, not another
  exception or nothing;
* RA199 -- the wrapper raised on its reference inputs, could not be
  loaded, or never reached ``_build.launch``;
* RA100 verified -- none of the above, anchored at the wrapper's
  ``_build.launch`` line.

On a card (``device="cuda"``) the wrapper runs for real: the kernel is
built, launched and counted, and a build or launch failure is RA199.  On
the CPU (``device="cpu"``) nothing can launch, so ``_build.launch`` is
replaced by a recorder for the run (as the reference replaces
``pl.pallas_call``), and the inputs lie on the host, which stands in for
the card in the wrappers' device check; every other check runs as it
does on the card.

The reference's RA101-RA106 check Pallas ``BlockSpec``s, grids and the
VMEM budget.  The CUDA kernels have none of these, and this pass has no
counterpart to them.

Fixture / third-party modules declare targets with a module-level
``ANALYSIS_TARGETS = [{"fn": ..., "args": ..., "bad_args": [...]}]``,
where ``args`` and each ``bad_args`` entry take the device and return
``(args, kwargs)``; the checker picks those up for any ``.py`` file
passed on the command line.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterable, List
from unittest import mock

import torch

from repro_torch.analysis.findings import Finding, Severity


@dataclass
class KernelTarget:
    """One kernel wrapper to verify."""

    name: str
    module: str                      # import path ("repro_torch.kernels...") or file
    fn: str
    make_args: Callable              # (device) -> (args tuple, kwargs dict)
    bad_args: list = field(default_factory=list)  # callables, same signature


def repo_targets() -> List[KernelTarget]:
    """The port's seven CUDA kernel wrappers, one per TPU kernel."""
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    def gather_args(d):
        return (z((4096, 128), f32, d), z((512,), i32, d)), {}

    def gather_bad_ids(d):
        return (z((4096, 128), f32, d), z((512,), torch.int64, d)), {}

    def gather_bad_table(d):
        return (z((4096,), f32, d), z((512,), i32, d)), {}

    def uniq_args(d):
        ids = z((1024,), i32, d)
        return (ids, 512, torch.arange(1024, device=d)), {}

    def uniq_bad_cap(d):
        ids = z((1024,), i32, d)
        return (ids, 0, torch.arange(1024, device=d)), {}  # cap must be >= 1

    def uniq_bad_order(d):
        ids = z((1024,), i32, d)
        return (ids, 512, torch.arange(1000, device=d)), {}

    def frontier_args(d):
        return (z((4097,), i32, d), z((8192,), i32, d), z((512,), i32, d)), dict(
            max_degree=16)

    def frontier_bad_seeds(d):
        return (z((4097,), i32, d), z((8192,), i32, d), z((512, 2), i32, d)), dict(
            max_degree=16)

    def frontier_bad_degree(d):
        return (z((4097,), i32, d), z((8192,), i32, d), z((512,), i32, d)), dict(
            max_degree=-1)

    def expand_args(d):
        return (z((257,), i32, d), 4096), {}

    def expand_bad_edges(d):
        return (z((257,), i32, d), -1), {}

    def expand_bad_indptr(d):
        return (z((0,), i32, d), 4096), {}

    def spmm_args(d):
        return (z((8192, 128), f32, d), z((128, 16), i32, d),
                torch.ones((128, 16), dtype=torch.bool, device=d), True), {}

    def spmm_bad_mask(d):
        return (z((8192, 128), f32, d), z((128, 16), i32, d),
                torch.ones((128, 8), dtype=torch.bool, device=d), True), {}

    def spmm_bad_dtype(d):
        return (z((8192, 128), torch.float64, d), z((128, 16), i32, d),
                torch.ones((128, 16), dtype=torch.bool, device=d), True), {}

    def seg_args(d):
        return (z((512, 16), f32, d), torch.ones((512, 16), dtype=torch.bool, device=d)), {}

    def seg_bad(d):
        return (z((500, 16), f32, d), torch.ones((512, 16), dtype=torch.bool, device=d)), {}

    def probe_args(d):
        return (z((2048, 8), i32, d), z((512,), i32, d), z((512,), i32, d)), {}

    def probe_bad(d):
        return (z((2048, 8), i32, d), z((500,), i32, d), z((512,), i32, d)), {}

    return [
        KernelTarget(
            "gather", "repro_torch.kernels.gather.ops", "gather_cuda",
            gather_args, [gather_bad_ids, gather_bad_table],
        ),
        KernelTarget(
            "unique_compact", "repro_torch.kernels.unique_compact.ops",
            "unique_compact_cuda", uniq_args, [uniq_bad_cap, uniq_bad_order],
        ),
        KernelTarget(
            "frontier_gather", "repro_torch.kernels.frontier_gather.ops",
            "frontier_gather_cuda", frontier_args,
            [frontier_bad_seeds, frontier_bad_degree],
        ),
        KernelTarget(
            "expand_indptr", "repro_torch.kernels.expand_indptr.ops",
            "expand_indptr_cuda", expand_args, [expand_bad_edges, expand_bad_indptr],
        ),
        KernelTarget(
            "spmm", "repro_torch.kernels.spmm.ops", "spmm_cuda",
            spmm_args, [spmm_bad_mask, spmm_bad_dtype],
        ),
        KernelTarget(
            "seg_softmax", "repro_torch.kernels.seg_softmax.ops",
            "seg_softmax_cuda", seg_args, [seg_bad],
        ),
        KernelTarget(
            "tag_probe", "repro_torch.store.kernel", "tag_probe_cuda",
            probe_args, [probe_bad],
        ),
    ]


# --- launch interception ---------------------------------------------------

@dataclass
class _LaunchSite:
    kernel: str
    entry: str
    file: str = "<unknown>"
    line: int = 0


class _Recorder:
    """Stands in for ``_build.launch``: records the call site, then
    launches through ``real`` (on a card) or not at all (on the CPU)."""

    def __init__(self, real: Callable = None):
        self.real = real
        self.sites: List[_LaunchSite] = []

    def __call__(self, name, fn, *args, counter=None):
        # anchor the finding at the _build.launch( source line
        stack = traceback.extract_stack()
        frame = stack[-2] if len(stack) >= 2 else None
        self.sites.append(_LaunchSite(
            kernel=counter or name, entry=fn,
            file=frame.filename if frame else "<unknown>",
            line=frame.lineno if frame else 0,
        ))
        if self.real is not None:
            self.real(name, fn, *args, counter=counter)


@contextmanager
def _recording(device: torch.device):
    from repro_torch.kernels import _build

    if device.type == "cuda":
        recorder = _Recorder(real=_build.launch)
        with mock.patch.object(_build, "launch", recorder):
            yield recorder
        return
    recorder = _Recorder()
    with mock.patch.object(_build, "launch", recorder), \
            mock.patch.object(_build, "call_int", lambda *a, **k: 0), \
            mock.patch.object(_build, "KERNEL_DEVICE", device.type):
        yield recorder


# --- target execution ------------------------------------------------------

def _load_module(target: KernelTarget):
    if target.module.endswith(".py") or os.sep in target.module:
        name = "_ra_fixture_" + os.path.basename(target.module)[:-3]
        spec = importlib.util.spec_from_file_location(name, target.module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(target.module)


def check_target(target: KernelTarget, device: torch.device) -> List[Finding]:
    findings: List[Finding] = []
    try:
        mod = _load_module(target)
        fn = getattr(mod, target.fn)
    except Exception as e:
        return [Finding(
            rule="RA199", severity=Severity.ERROR,
            message=f"could not load kernel target "
                    f"{target.module}:{target.fn}: {e!r}",
            file=target.module,
        )]
    mod_file = getattr(mod, "__file__", target.module) or target.module

    with _recording(device) as recorder:
        args, kwargs = target.make_args(device)
        try:
            fn(*args, **kwargs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # a launch fault surfaces here
        except Exception as e:
            findings.append(Finding(
                rule="RA199", severity=Severity.ERROR,
                message=f"kernel wrapper `{target.fn}` raised on its "
                        f"reference inputs: {e!r}",
                file=mod_file,
            ))
        good_sites = list(recorder.sites)
        # typed-precondition probes
        for i, bad in enumerate(target.bad_args):
            bargs, bkwargs = bad(device)
            try:
                fn(*bargs, **bkwargs)
            except Exception as e:
                if type(e).__name__ == "KernelContractError":
                    continue
                findings.append(Finding(
                    rule="RA107", severity=Severity.ERROR,
                    message=f"`{target.fn}` bad-shape probe #{i} "
                            f"raised {type(e).__name__} instead of "
                            "KernelContractError -- preconditions "
                            "must be typed, not bare asserts",
                    file=mod_file,
                    extra=dict(raised=type(e).__name__),
                ))
            else:
                findings.append(Finding(
                    rule="RA107", severity=Severity.ERROR,
                    message=f"`{target.fn}` bad-shape probe #{i} was "
                            "accepted silently -- add a "
                            "KernelContractError precondition",
                    file=mod_file,
                ))

    if not good_sites and not any(f.rule == "RA199" for f in findings):
        findings.append(Finding(
            rule="RA199", severity=Severity.ERROR,
            message=f"`{target.fn}` never reached _build.launch on its "
                    "reference inputs -- nothing to verify",
            file=mod_file,
        ))
    if good_sites and not any(f.severity >= Severity.ERROR for f in findings):
        site = good_sites[0]
        ran = "launched" if device.type == "cuda" else "recorded, not run"
        findings.append(Finding(
            rule="RA100", severity=Severity.INFO,
            message=f"verified on {device.type}: `{target.fn}` reached "
                    f"{site.kernel}.{site.entry} ({len(good_sites)} launch(es) "
                    f"{ran}); {len(target.bad_args)} bad-input probe(s) raised "
                    "KernelContractError",
            file=site.file, line=site.line,
            extra=dict(kernel=target.name, launches=len(good_sites),
                       probes=len(target.bad_args), device=device.type),
        ))
    return findings


# --- discovery over CLI paths ----------------------------------------------

def _path_covers(path: str, file: str) -> bool:
    p = os.path.abspath(path)
    f = os.path.abspath(file)
    return f == p or f.startswith(p.rstrip(os.sep) + os.sep)


def fixture_targets(py_file: str) -> List[KernelTarget]:
    """Targets declared via ``ANALYSIS_TARGETS`` in an arbitrary file."""
    try:
        with open(py_file, "r", encoding="utf-8") as fh:
            if "ANALYSIS_TARGETS" not in fh.read():
                return []
    except OSError:
        return []
    name = "_ra_scan_" + os.path.basename(py_file)[:-3]
    try:
        spec = importlib.util.spec_from_file_location(name, py_file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception:
        return []
    targets = []
    for decl in getattr(mod, "ANALYSIS_TARGETS", []) or []:
        targets.append(KernelTarget(
            name=f"{os.path.basename(py_file)[:-3]}:{decl['fn']}",
            module=py_file,
            fn=decl["fn"],
            make_args=decl["args"],
            bad_args=list(decl.get("bad_args", [])),
        ))
    return targets


def run_contracts(paths: Iterable[str], device: torch.device) -> List[Finding]:
    from repro_torch.analysis.lint import iter_python_files

    findings: List[Finding] = []
    paths = list(paths)

    # the port's kernels, when a path covers the kernels package
    import repro_torch.kernels as _k

    kdir = os.path.dirname(os.path.abspath(_k.__file__))
    if any(_path_covers(p, kdir) or _path_covers(kdir, p) for p in paths):
        for target in repo_targets():
            findings.extend(check_target(target, device))

    # fixture-declared targets anywhere under the given paths
    for py in iter_python_files(paths):
        if _path_covers(kdir, py):
            continue  # the port's kernels already covered above
        for target in fixture_targets(py):
            findings.extend(check_target(target, device))
    return findings

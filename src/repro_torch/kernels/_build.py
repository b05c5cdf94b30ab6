"""Build, load and count the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``src/repro_torch/`` is one kernel library with
a plain C interface.  At first use all of them are compiled at once, one
``nvcc`` process per source started together, for ``sm_90a`` (Hopper),
into ``build/torch_kernels/`` at the repository root, and loaded with
``ctypes``.  A library is named by the hash of its source, of every
shared header (``*.cuh``) under the package and of the flags, so an
edited source or header rebuilds and an unchanged one is reused.

Nothing here is imported or compiled at module import time, and nothing
falls back: a failed build or a launch error raises.

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds
one right where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels.

A launch given fake or meta tensors (a dry-run's trace,
``repro_torch.launch.op_costs``) calls nothing: it charges the active
``CostCounter`` with the launch and its tensors' bytes, and leaves
``LAUNCHES`` as it was.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels.errors import KernelContractError

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: dict[str, int] = {}
#: the device type every kernel input must lie on (the contract checker's
#: recording run on a host without a card sets it to "cpu")
KERNEL_DEVICE = "cuda"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def sources() -> dict[str, Path]:
    """Kernel name (the ``.cu`` stem) -> source path."""
    return {p.stem: p for p in sorted(PACKAGE_DIR.rglob("*.cu"))}


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        path = Path(root) / "bin" / "nvcc"
        if root and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(PACKAGE_DIR.rglob("*.cuh")):
        h.update(header.relative_to(PACKAGE_DIR).as_posix().encode() + header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source not yet built, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    jobs = {}
    for name, src in srcs.items():
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(src) for name, src in srcs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (builds everything on first use)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no kernel source named {name}.cu")
            for lib_name, path in paths.items():
                _libs.setdefault(lib_name, ctypes.CDLL(str(path)))
        return _libs[name]


def launch(name: str, fn: str, *args, counter: str | None = None) -> None:
    """Call C entry point ``fn`` of kernel library ``name``, check its error
    code, and count the launch under ``counter`` (default ``name``).

    Each argument is a tensor (passed as its device pointer), ``None`` (a
    null pointer) or a python int (passed as a 64-bit integer); the current
    CUDA stream is appended.  The C function returns ``cudaGetLastError()`` after its
    launch; a non-zero code raises.  Fake or meta tensors (a trace) are
    recorded by the active ``CostCounter`` instead, and nothing is called.
    """
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors:
        from repro_torch.launch.op_costs import active_counter, is_traced

        if any(is_traced(t) for t in tensors):
            cc = active_counter()
            if cc is None:
                raise RuntimeError(f"{name}.{fn}: fake or meta tensors outside a CostCounter")
            cc.record_kernel(counter or name, tensors)
            return
    cfn = _entries.get((name, fn))
    if cfn is None:  # configured once per entry point, at its first call
        cfn = getattr(library(name), fn)
        cfn.argtypes = [
            ctypes.c_void_p if a is None or isinstance(a, torch.Tensor) else ctypes.c_longlong
            for a in args
        ] + [ctypes.c_void_p]
        cfn.restype = ctypes.c_int
        _entries[(name, fn)] = cfn
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a if a is None else int(a)
             for a in args]
    err = cfn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA launch failed with error {err}")
    count_launch(counter or name)


def call_int(name: str, fn: str, *args: int) -> int:
    """The value of C function ``fn`` of kernel library ``name``, which takes
    and returns 64-bit ints -- a kernel's scratch size, worked out beside
    the layout that uses it.  It launches nothing and counts nothing."""
    key = (name, fn)
    cfn = _entries.get(key)
    if cfn is None:
        cfn = getattr(library(name), fn)
        cfn.argtypes = [ctypes.c_longlong] * len(args)
        cfn.restype = ctypes.c_longlong
        _entries[key] = cfn
    return int(cfn(*(int(a) for a in args)))


def require_cuda(kernel: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise :class:`KernelContractError` unless every tensor is a
    contiguous CUDA tensor of ``dtype``."""
    for key, t in tensors.items():
        if t.device.type != KERNEL_DEVICE:
            raise KernelContractError(kernel, f"{key} is on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise KernelContractError(kernel, f"{key} has dtype {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise KernelContractError(kernel, f"{key} is not contiguous",
                                      {"stride": tuple(t.stride())})


def require_cuda_int32(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor."""
    require_cuda(kernel, torch.int32, **tensors)

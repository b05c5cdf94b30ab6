"""Clean fixture: good key discipline + a well-checked kernel launch site.

Must produce zero error findings under every pass: keys are split
before reuse, and the wrapper checks its inputs with
``KernelContractError`` before it reaches ``_build.launch``, which the
contracts pass records (the ``copy`` library exists only in this
fixture, so it runs on the CPU only).
"""
import torch

from repro_torch.core import threefry
from repro_torch.kernels import _build
from repro_torch.kernels.errors import KernelContractError


def init_params(seed):
    key = threefry.prng_key(seed)
    key, kw = threefry.split(key)
    w = threefry.uniform(kw, (4, 4))
    key, kb = threefry.split(key)
    b = threefry.uniform(kb, (4,))
    return w, b


def good_copy(x):
    _build.require_cuda("copy", torch.float32, x=x)
    if x.ndim != 1:
        raise KernelContractError("copy", "want an (n,) vector",
                                  {"x": tuple(x.shape)})
    (n,) = x.shape
    if n >= 2**31:
        raise KernelContractError("copy", "n exceeds the int32 index range",
                                  {"n": n})
    out = torch.empty_like(x)  # the kernel writes every element
    # one launch, counted under the library's name
    if n:
        _build.launch(
            "copy", "copy_launch", x, out, n,
        )
    return out


ANALYSIS_TARGETS = [
    {
        "fn": "good_copy",
        "args": lambda device: ((torch.zeros((16,), device=device),), {}),
        "bad_args": [
            lambda device: ((torch.zeros((4, 4), device=device),), {}),
        ],
    },
]

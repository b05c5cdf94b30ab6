"""Known-bad fixture: bare assert as a kernel precondition -> one RA005.

The module launches a kernel through ``_build.launch``, so it is a
kernel module, and its precondition must be typed.
"""
import torch

from repro_torch.kernels import _build


def loose_copy(x, out):
    assert x.shape == out.shape  # <- RA005: vanishes under python -O
    _build.launch("copy", "copy_launch", x, out, x.shape[0])
    return out


def copy(x):
    return loose_copy(x, torch.empty_like(x))

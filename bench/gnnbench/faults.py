"""Faults planted in the system under test, and the control, to show that
the output check fails them (``bench/control.py`` at a cell's own size on
the card, ``bench/tests`` at a tiny size on the CPU).

Each fault is a context manager that patches one function of
``repro_torch`` for the duration of a run:

* ``state_unchanged``: Adam leaves the weights, the moments and its step as
  they were (a step that returns its state unchanged);
* ``half_batch``: the loss averages over the first half of the valid seeds
  only (half of the batch left out, the mean taken over the rest);
* ``no_exchange``: the PEs' all-to-all hands every PE its own buffer back
  (the exchange between the PEs left out; cooperative cells only);
* ``grad_altered``: the gradient of the first layer's first leaf doubled
  where autograd hands it to Adam (an answer altered where it is produced).

The control is not a patch: the reference computed with TF32 matrix
products (:func:`control_numbers`).
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "grad_altered")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault: str):
    """The context manager that plants ``fault`` in ``repro_torch``."""
    from repro_torch.core import cooperative
    from repro_torch.train import loop

    if fault == "state_unchanged":
        return _patched(loop, "adam_update", lambda params, grads, opt, **kw: opt)
    if fault == "half_batch":
        xent = loop.masked_softmax_xent

        def half(logits, labels, valid):
            rank = torch.cumsum(valid.to(torch.int32), 0)
            return xent(logits, labels, valid & (2 * rank <= valid.sum()))

        return _patched(loop, "masked_softmax_xent", half)
    if fault == "no_exchange":
        return _patched(cooperative.SimExecutor, "exchange", lambda self, x: x.contiguous())
    if fault == "grad_altered":
        adam = loop.adam_update

        def altered(params, grads, opt, **kw):
            grads = list(grads)
            grads[0] = grads[0] * 2
            return adam(params, grads, opt, **kw)

        return _patched(loop, "adam_update", altered)
    raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")


def control_numbers(ref, feats_of, w0: dict, steps: int, beta1: float, log=None) -> dict:
    """The output check's numbers of the control: the reference trained in
    TF32 put in the program's place, against the reference in float32."""
    from gnnbench.harness import compare

    want = ref.train(feats_of, w0, steps)
    got = ref.train(feats_of, w0, steps, tf32=True)
    prog = {"losses": got["losses"], "weights": got["weights"],
            "mu0": {k: (1 - beta1) * g for k, g in got["grads"].items()}}
    return compare(prog, want, w0, beta1, log)

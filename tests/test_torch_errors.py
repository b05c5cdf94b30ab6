"""``KernelContractError`` of the port (``repro_torch.kernels.errors``).

Its message format and ``require_divisible`` equal the JAX package's;
every kernel wrapper raises it, naming its kernel, for a CPU tensor given
to a CUDA kernel, for a device it does not run on, and for inputs of the
wrong shape (checked here with the device check switched off and every
launch refused, so the shape checks are reached on the CPU).  It is a
``ValueError``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.errors import KernelContractError as JKernelContractError
from repro.kernels.errors import require_divisible as j_require_divisible
from repro_torch.kernels import KernelContractError, _build, require_divisible
from repro_torch.kernels.exchange import (
    exchange_backward_cuda,
    exchange_forward_cuda,
    exchange_rows,
    exchange_tables,
    exchange_tables_cuda,
)
from repro_torch.kernels.expand_indptr import expand_indptr, expand_indptr_cuda
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_cuda
from repro_torch.kernels.gather import gather, gather_cuda
from repro_torch.kernels.seg_softmax import seg_softmax, seg_softmax_backward_cuda, seg_softmax_cuda
from repro_torch.kernels.spmm import spmm_backward_cuda, spmm_cuda, spmm_sum
from repro_torch.kernels.unique_compact import unique_compact_cuda, unique_with_inverse
from repro_torch.store import tag_probe, tag_probe_cuda

torch.set_num_threads(1)  # the suite runs files in parallel workers


def test_message_format_equals_jax():
    for args in (("spmm", "bad"), ("gather", "want (n,) ids", {"ids": (2, 3), "d": 4})):
        port, ref = KernelContractError(*args), JKernelContractError(*args)
        assert str(port) == str(ref)
        assert (port.kernel, port.values) == (ref.kernel, ref.values)
        assert isinstance(port, ValueError)
    cases = [("n", 10, "block", 4), ("d", 8, "lanes", 4), ("m", 7, "tile", 0)]
    with pytest.raises(KernelContractError) as port:
        require_divisible("unique_compact", cases)
    with pytest.raises(JKernelContractError) as ref:
        j_require_divisible("unique_compact", cases)
    assert str(port.value) == str(ref.value)
    assert port.value.values == {"n": 10, "block": 4, "m": 7, "tile": 0}
    require_divisible("unique_compact", [("n", 8, "block", 4)])  # holds: no raise


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _mask(*shape):
    return torch.ones(shape, dtype=torch.bool)


# each CUDA wrapper on well-formed CPU inputs: refused as not CUDA
ON_CPU = {
    "frontier_gather": lambda: frontier_gather_cuda(_i32(5), _i32(4), _i32(3), 2),
    "unique_compact": lambda: unique_compact_cuda(_i32(6), 4, torch.arange(6)),
    "tag_probe": lambda: tag_probe_cuda(_i32(4, 2), _i32(3), _i32(3)),
    "gather": lambda: gather_cuda(_f32(8, 4), _i32(3)),
    "spmm": lambda: spmm_cuda(_f32(8, 4), _i32(6, 3), _mask(6, 3), mean=False),
    "spmm_backward": lambda: spmm_backward_cuda(_f32(6, 4), _i32(6, 3), _mask(6, 3), 8, mean=True),
    "seg_softmax": lambda: seg_softmax_cuda(_f32(6, 3, 2), _mask(6, 3)),
    "seg_softmax_backward": lambda: seg_softmax_backward_cuda(_f32(6, 3, 2), _f32(6, 3, 2),
                                                              _mask(6, 3)),
    "expand_indptr": lambda: expand_indptr_cuda(_i32(5), 8),
    "exchange_invert": lambda: exchange_tables_cuda(_i32(2, 2, 3), _i32(2, 2, 3), 4, 5, True),
    "exchange": lambda: exchange_forward_cuda(_f32(2, 5, 4), _i32(2, 4)),
    "exchange_backward": lambda: exchange_backward_cuda(_f32(2, 4, 4), _i32(2, 5, 2)),
}

# each CUDA wrapper on inputs of the wrong shape
BAD_SHAPE = {
    "frontier_gather": lambda: frontier_gather_cuda(_i32(5), _i32(4), _i32(3, 2), 2),
    "unique_compact": lambda: unique_compact_cuda(_i32(6), 4, torch.arange(5)),
    "tag_probe": lambda: tag_probe_cuda(_i32(4, 2), _i32(4), _i32(3)),
    "gather": lambda: gather_cuda(_f32(8), _i32(3)),
    "spmm": lambda: spmm_cuda(_f32(8, 4), _i32(6, 3), _mask(6, 2), mean=False),
    "spmm_backward": lambda: spmm_backward_cuda(_f32(5, 4), _i32(6, 3), _mask(6, 3), 8, mean=True),
    "seg_softmax": lambda: seg_softmax_cuda(_f32(6, 2, 2), _mask(6, 3)),
    "seg_softmax_backward": lambda: seg_softmax_backward_cuda(_f32(6, 3, 2), _f32(6, 3, 1),
                                                              _mask(6, 3)),
    "expand_indptr": lambda: expand_indptr_cuda(_i32(2, 3), 8),
    "exchange_invert": lambda: exchange_tables_cuda(_i32(2, 2, 3), _i32(2, 3, 3), 4, 5, True),
    "exchange": lambda: exchange_forward_cuda(_f32(2, 5, 4), _i32(3, 4)),
    "exchange_backward": lambda: exchange_backward_cuda(_f32(2, 4, 4), _i32(2, 5, 3)),
}


@pytest.mark.parametrize("kernel", list(ON_CPU))
def test_cuda_wrappers_raise_named_contract_error_on_cpu(kernel):
    with pytest.raises(KernelContractError, match="not CUDA") as err:
        ON_CPU[kernel]()
    assert err.value.kernel == kernel
    assert str(err.value).startswith(f"{kernel}: ")


@pytest.fixture
def shapes_only(monkeypatch):
    """The device check off and every launch refused: a call that passes its
    shape checks fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the launch with inputs of the wrong shape")

    monkeypatch.setattr(_build, "require_cuda", lambda kernel, dtype, **tensors: None)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "call_int", refuse)


@pytest.mark.parametrize("kernel", list(BAD_SHAPE))
def test_cuda_wrappers_raise_named_contract_error_on_bad_shape(shapes_only, kernel):
    with pytest.raises(KernelContractError) as err:
        BAD_SHAPE[kernel]()
    assert err.value.kernel == kernel
    assert err.value.values  # the offending values are named


def test_unique_compact_cap_and_expand_indptr_edges(shapes_only):
    with pytest.raises(KernelContractError, match="cap") as err:
        unique_compact_cuda(_i32(6), 0, torch.arange(6))
    assert err.value.values == {"cap": 0}
    with pytest.raises(KernelContractError, match="num_edges"):
        expand_indptr_cuda(_i32(5), -1)


def test_public_wrappers_raise_named_contract_error_on_other_devices():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    calls = {
        "frontier_gather": lambda: frontier_gather(meta, meta, meta, 2),
        "unique_compact": lambda: unique_with_inverse(meta, 2),
        "tag_probe": lambda: tag_probe(meta.reshape(2, 2), meta, meta),
        "gather": lambda: gather(meta.reshape(2, 2).float(), meta),
        "spmm": lambda: spmm_sum(meta.reshape(2, 2).float(), meta.reshape(2, 2),
                                 meta.reshape(2, 2).bool()),
        "seg_softmax": lambda: seg_softmax(meta.reshape(2, 2).float(), meta.reshape(2, 2).bool()),
        "expand_indptr": lambda: expand_indptr(meta, 3),
        "exchange_invert": lambda: exchange_tables(meta.reshape(1, 1, 4), meta.reshape(1, 1, 4),
                                                   2, 2, False),
        "exchange": lambda: exchange_rows(meta.reshape(1, 4, 1).float(), meta.reshape(1, 4)),
    }
    for kernel, call in calls.items():
        with pytest.raises(KernelContractError, match="unsupported device") as err:
            call()
        assert err.value.kernel == kernel


def test_plain_paths_unchanged_on_cpu():
    """A CPU tensor still takes the plain version, not the contract check."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    ids = torch.tensor([1, 2**31 - 1, 7], dtype=torch.int32)
    out = gather(table, ids)
    assert torch.equal(out[0], table[1]) and not out[1].any()

"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``).

Each kernel ships as a ``.cu`` source with a plain C interface, an
``ops.py`` wrapper (plain torch version for CPU tensors, the kernel for
CUDA tensors, a launch counter) and a ``ref.py`` plain version.  The
build lives in :mod:`repro_torch.kernels._build`.  A wrapper given inputs
its kernel does not take raises :class:`KernelContractError`
(:mod:`repro_torch.kernels.errors`, a ``ValueError``).

Ported so far (TPU kernel it replaces in brackets):

* ``frontier_gather`` -- masked CSR neighbor expansion
  [``repro/kernels/frontier_gather/kernel.py``];
* ``unique_compact``  -- frontier dedup + rank resolution after a sort
  [``repro/kernels/unique_compact/kernel.py``];
* ``gather``          -- masked embedding-row gather (feature loading)
  [``repro/kernels/gather/kernel.py``];
* ``spmm``            -- masked neighbor sum/mean, with a backward kernel
  (counted as ``spmm_backward``) [``repro/kernels/spmm/kernel.py``];
* ``seg_softmax``     -- masked edge softmax (GAT), with a backward kernel
  (counted as ``seg_softmax_backward``) [``repro/kernels/seg_softmax/kernel.py``];
* ``expand_indptr``   -- CSR indptr -> row id of each edge slot
  (``layer_to_coo``) [``repro/kernels/expand_indptr/kernel.py``];
* ``tag_probe``       -- device cache tag lookup, in
  :mod:`repro_torch.store.kernel` [``repro/store/kernel.py``];
* ``span_marker``     -- one end of a program's span stamped with the
  device's timer (:mod:`repro_torch.utils.spans`) [none: a captured graph
  shows kernels but not the stage that launched them].
"""
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.errors import KernelContractError, require_divisible
from repro_torch.kernels.expand_indptr.ops import expand_indptr
from repro_torch.kernels.frontier_gather.ops import frontier_gather
from repro_torch.kernels.gather.ops import gather
from repro_torch.kernels.seg_softmax.ops import seg_softmax
from repro_torch.kernels.spmm.ops import spmm_mean, spmm_sum
from repro_torch.kernels.unique_compact.ops import unique_compact, unique_with_inverse

__all__ = [
    "KernelContractError", "LAUNCHES", "expand_indptr", "frontier_gather", "gather",
    "require_divisible", "reset_launches", "seg_softmax", "spmm_mean", "spmm_sum",
    "unique_compact", "unique_with_inverse",
]

"""The single-device executor's redistribution as it was before the
valid-rows exchange (:func:`padded_chain`), the yardstick its plain
version and kernels are held to, and plan tables drawn with the plan's
invariants (:func:`drawn_tables`, :data:`CASES`): for
``tests/test_torch_exchange.py``, ``tests/test_torch_exchange_gpu.py``,
and ``tests/test_torch_shard.py``."""
import dataclasses

import numpy as np
import torch

from repro_torch.core import frontier


def padded_chain(P, layer, H, cap_tilde):
    """The SimExecutor's redistribution before the index map: every bucket
    slot gathered, the axis swapped, every slot scattered."""
    send = torch.stack([frontier.take_rows(H[q], layer.req_idx[q]) for q in range(P)])
    recv = send.transpose(0, 1).contiguous()
    outs = []
    for p in range(P):
        d = recv.shape[-1]
        valid = layer.slot_to_tilde[p] >= 0
        pos = torch.where(valid, layer.slot_to_tilde[p], cap_tilde).reshape(-1)
        out = recv.new_zeros((cap_tilde + 1, d))
        outs.append(out.index_put((pos.long(),), recv[p].reshape(-1, d))[:cap_tilde])
    return torch.stack(outs)


@dataclasses.dataclass(frozen=True)
class Tables:
    slot_to_tilde: torch.Tensor
    req_idx: torch.Tensor


def drawn_tables(P, cap_b, cap_tilde, cap_next, *, rows_a_pe, owner_drop=0.0, pool=None,
                 seed=0):
    """Plan tables with the plan's invariants: each PE's ``rows_a_pe`` tilde
    rows go to random owners' buckets (kept up to ``cap_b`` a bucket, the
    rest dropped), each kept slot names a row of its owner that is distinct
    within the bucket (from the first ``pool`` rows, so that several peers
    ask for one row) or, with probability ``owner_drop``, -1."""
    rng = np.random.default_rng(seed)
    s2t = np.full((P, P, cap_b), -1, np.int32)
    req = np.full((P, P, cap_b), -1, np.int32)
    for p in range(P):
        tilde = rng.permutation(cap_tilde)[:rows_a_pe]
        owner = rng.integers(0, P, rows_a_pe)
        for q in range(P):
            kept = tilde[owner == q][:cap_b]
            s2t[p, q, :len(kept)] = kept
            rows = rng.permutation(pool or cap_next)[:len(kept)]
            rows[rng.random(len(kept)) < owner_drop] = -1
            req[q, p, :len(kept)] = rows
    return Tables(torch.from_numpy(s2t), torch.from_numpy(req))


CASES = {
    "padding": dict(P=4, cap_b=40, cap_tilde=96, cap_next=120, rows_a_pe=50),
    "over_capacity": dict(P=4, cap_b=6, cap_tilde=64, cap_next=30, rows_a_pe=60,
                          owner_drop=0.3),
    "shared_rows": dict(P=4, cap_b=12, cap_tilde=48, cap_next=200, rows_a_pe=40, pool=12),
    "three_pes": dict(P=3, cap_b=9, cap_tilde=20, cap_next=17, rows_a_pe=15, owner_drop=0.1),
    "one_pe": dict(P=1, cap_b=7, cap_tilde=9, cap_next=11, rows_a_pe=8),
}

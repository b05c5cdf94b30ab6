"""The plan check: a step's plan as the program built it, against the
reference's layout of the same step (``Reference.pe_work``), PE by PE and
layer by layer.

What a plan means is compared, not where it keeps it: each PE's
destination ids of each layer, its kept edges (destination, source and
relation), the rows its self and neighbor indices resolve to, its input
ids and, in cooperative mode, its request frontier ``S~`` and the exchange
maps.  Of the exchange, every valid ``S~`` row of PE ``p`` has to go out in
exactly one bucket slot, to the PE that owns its id, and the request row
that the owner resolves that slot to has to hold the same id.  Each count
is the size of a multiset difference, or of the rows that break a rule.
"""
from __future__ import annotations

import torch

from gnnbench.sampling import INVALID


def _diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements by which two multisets of ids differ."""
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    if got.numel() + want.numel() == 0:
        return 0
    uniq, inv = torch.unique(torch.cat([got, want]), return_inverse=True)
    n = uniq.numel()
    a = torch.bincount(inv[: got.numel()], minlength=n)
    b = torch.bincount(inv[got.numel():], minlength=n)
    return int((a - b).abs().sum())


def _take(table: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``table[idx]`` with out-of-range indices read as ``INVALID``, and how
    many there were."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < table.numel())
    return torch.where(ok, table[torch.where(ok, idx, 0)].long(), INVALID), int((~ok).sum())


def _edge_keys(dst, src, et, num_vertices: int, num_relations: int) -> torch.Tensor:
    key = dst.long() * num_vertices + src.long()
    return key * num_relations + (et.long() if et is not None else 0)


def mismatch(plan, work: list, owner: torch.Tensor, num_vertices: int, num_relations: int,
             cooperative: bool) -> dict:
    """``{part: ids or rows that differ}`` of one step's plan (the stacked
    ``(P, ...)`` layout of the simulated PEs) against ``work``."""
    bad = {"seeds": 0, "edges": 0, "self": 0, "inputs": 0}
    if cooperative:
        bad.update({"tilde": 0, "exchange": 0})
    layers = plan.layers
    for l, lay in enumerate(layers):
        nxt = layers[l + 1].seeds if l + 1 < len(layers) else plan.input_ids
        for p, pe in enumerate(work):
            dst, nbr, keep, et = pe["layers"][l]
            seeds = lay.seeds[p].long()
            valid = seeds != INVALID
            bad["seeds"] += _diff(seeds[valid], dst)
            # the rows the block's indices resolve to: S~ (cooperative) or S^{l+1}
            rows = lay.tilde_ids[p] if cooperative else nxt[p]
            m = lay.mask[p] & valid[:, None]
            src, out = _take(rows, lay.nbr_idx[p][m])
            bad["self"] += out
            ets = lay.etypes[p][m] if lay.etypes is not None else None
            got = _edge_keys(seeds[:, None].expand_as(m)[m], src, ets, num_vertices,
                             num_relations)
            want = _edge_keys(dst[:, None].expand_as(keep)[keep], nbr[keep],
                              et[keep] if lay.etypes is not None else None, num_vertices,
                              num_relations)
            bad["edges"] += _diff(got, want)
            own, out = _take(rows, lay.self_idx[p][valid])
            bad["self"] += out + int((own != seeds[valid]).sum())
            if cooperative:
                bad["tilde"] += _diff(rows[rows != INVALID],
                                      torch.unique(torch.cat([dst, nbr[keep]])))
                bad["exchange"] += _exchange(lay, nxt, p, owner)
    for p, pe in enumerate(work):
        ids = plan.input_ids[p].long()
        bad["inputs"] += _diff(ids[ids != INVALID], pe["inputs"])
    return bad


def _exchange(lay, nxt: torch.Tensor, p: int, owner: torch.Tensor) -> int:
    """Rows of PE ``p``'s exchange at one layer that break its rules."""
    tilde = lay.tilde_ids[p].long()
    s2t = lay.slot_to_tilde[p].long()                  # (P, cap_b): slot -> S~ row
    used = s2t >= 0
    peer = torch.arange(s2t.shape[0], device=s2t.device)[:, None].expand_as(s2t)[used]
    ids, bad = _take(tilde, s2t[used])
    bad += int((owner[torch.where(ids != INVALID, ids, 0)] != peer).sum())
    # the owner's request row of each slot: req_idx[q, p, j] into S_q^{l+1}
    req = lay.req_idx[:, p].long()[used]
    at = peer * nxt.shape[1] + req
    held, out = _take(nxt.reshape(-1), torch.where(req >= 0, at, -1))
    bad += out + int((held != ids).sum())
    # every valid S~ row goes out exactly once, padding never
    sent = torch.bincount(s2t[used].clamp(max=tilde.numel() - 1), minlength=tilde.numel())
    return bad + int((sent - (tilde != INVALID).long()).abs().sum())

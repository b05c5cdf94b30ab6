"""The plain reference: a training step of the configuration in plain PyTorch.

It takes the benchmark's inputs (the graph arrays, features, labels,
training ids and initial weights) and works out everything else itself:
the seed draw of each step, the sampled neighborhoods, the GCN or R-GCN
forward pass, the cross-entropy, the gradients (autograd) and Adam.  It
imports nothing of the system under test.

The model is evaluated on the union of the PEs' frontiers, indexed by
vertex id.  Each vertex's embedding at a layer depends only on its
sampled in-edges there, which LABOR-0 decides per vertex, so the logits
of a seed are the same in every minibatching mode and layout; the modes
differ in which PE does which part of the work, which :func:`pe_work`
lays out for the byte and operation counts.

Float32 throughout, with TF32 off.  ``tf32=True`` is the control: every
matrix product, forward and backward, takes its inputs rounded to TF32's
10-bit mantissa, as the card's TF32 tensor-core path does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gnnbench import sampling
from gnnbench.sampling import INVALID


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest
    with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).transpose(-1, -2), round_tf32(a).transpose(-1, -2) @ g


def matmul(a, b, tf32: bool):
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


@dataclass
class Layer:
    """Layer ``l`` on the union frontier: destination ids ``F_l`` (sorted),
    their neighbor table ``(n, D)`` (sources, kept slots, edge types) and
    the positions of the kept sources and of the destinations in
    ``F_{l+1}``."""

    dst: torch.Tensor
    nbr: torch.Tensor
    keep: torch.Tensor
    etypes: torch.Tensor
    pos_nbr: torch.Tensor
    pos_self: torch.Tensor


class Reference:
    """One run's reference: the inputs, the configuration, the mode
    (``"cooperative"`` or ``"independent"``), the PEs and the local batch."""

    def __init__(self, graph, labels, train_ids, config: dict, mode: str, num_pes: int,
                 local_batch: int, seed: int):
        self.g, self.labels, self.train_ids = graph, labels.long(), train_ids.long()
        self.model, self.sampler = config["model"], config["sampler"]
        self.optim = config["optimizer"]
        self.mode, self.seed = mode, int(seed)
        self.P, self.b = num_pes, local_batch
        self.dev = graph.indptr.device
        self._owner = None

    # -- seeds and sampling ----------------------------------------------
    @property
    def owner(self) -> torch.Tensor:
        if self._owner is None:
            self._owner = sampling.hash_owner_table(self.g.num_vertices, self.P, self.dev)
        return self._owner

    def seeds(self, step: int) -> torch.Tensor:
        """``(P, b)`` seed ids of ``step`` (int64): cooperative, each PE's
        own hash-keyed draw from the training ids it owns; independent,
        the first ``P * b`` of one draw from all of them."""
        P, b = self.P, self.b
        ids = self.train_ids
        if self.mode == "cooperative":
            own = self.owner[ids]
            rows = [ids[own == p] for p in range(P)]
        else:
            rows = [ids]
        width = max(max(r.numel() for r in rows), P * b if len(rows) == 1 else b)
        table = torch.full((len(rows), width), INVALID, dtype=torch.int64, device=self.dev)
        for i, r in enumerate(rows):
            table[i, : r.numel()] = r
        perm = sampling.permute_rows(table, sampling.draw_key(step, self.seed))
        return perm[0, : P * b].reshape(P, b) if len(rows) == 1 else perm[:, :b]

    def state(self, step: int) -> tuple:
        return sampling.rng_state(self.seed, self.sampler["kappa"], step)

    def sample(self, dst: torch.Tensor, state: tuple, layer: int):
        """The neighbor table of ``dst`` (sorted valid ids) and the slots
        LABOR-0 keeps: ``(nbr, keep, etypes)``."""
        g = self.g
        start = g.indptr[dst].long()
        deg = g.indptr[dst + 1].long() - start
        slot = torch.arange(g.max_degree, device=self.dev)
        valid = slot[None, :] < deg[:, None]
        pos = (start[:, None] + slot).clamp(max=max(g.indices.numel() - 1, 0))
        nbr = torch.where(valid, g.indices[pos].long(), INVALID)
        if g.etypes is None:
            et = torch.zeros_like(nbr)
        else:
            et = torch.where(valid, g.etypes[pos].long(), 0)
        keep = sampling.labor0_accept(nbr, valid, state, layer, self.sampler["fanout"])
        return nbr, keep, et

    def frontiers(self, seeds: torch.Tensor, step: int) -> tuple:
        """``(layers, F_L)`` on the union of the frontiers of ``seeds``."""
        state = self.state(step)
        F_l = torch.unique(seeds[seeds != INVALID])
        layers = []
        for l in range(self.model["num_layers"]):
            nbr, keep, et = self.sample(F_l, state, l)
            F_next = torch.unique(torch.cat([F_l, nbr[keep]]))
            pos = torch.searchsorted(F_next, torch.where(keep, nbr, F_l[:1, None]))
            layers.append(Layer(F_l, nbr, keep, et, pos, torch.searchsorted(F_next, F_l)))
            F_l = F_next
        return layers, F_l

    def pe_work(self, step: int) -> list:
        """Per PE and layer, the work the plan hands it: ``[{"layers": [
        (dst, nbr, keep, etypes) of each layer], "inputs": ids}]``.
        Cooperative: PE ``p`` holds the vertices of the union frontier that
        it owns.  Independent: each PE samples from its own seeds."""
        seeds = self.seeds(step)
        state = self.state(step)
        L = self.model["num_layers"]
        out = []
        if self.mode == "cooperative":
            layers, F_L = self.frontiers(seeds, step)
            for p in range(self.P):
                pe = []
                for lay in layers:
                    m = self.owner[lay.dst] == p
                    pe.append((lay.dst[m], lay.nbr[m], lay.keep[m], lay.etypes[m]))
                out.append({"layers": pe, "inputs": F_L[self.owner[F_L] == p]})
            return out
        for p in range(self.P):
            F_l = torch.unique(seeds[p][seeds[p] != INVALID])
            pe = []
            for l in range(L):
                nbr, keep, et = self.sample(F_l, state, l)
                pe.append((F_l, nbr, keep, et))
                F_l = torch.unique(torch.cat([F_l, nbr[keep]]))
            out.append({"layers": pe, "inputs": F_l})
        return out

    # -- the model ---------------------------------------------------------
    def _slot_sum(self, H, lay: Layer, mask) -> torch.Tensor:
        acc = H.new_zeros((lay.dst.numel(), H.shape[1]))
        for k in range(mask.shape[1]):
            acc = acc + torch.where(mask[:, k, None], H[lay.pos_nbr[:, k]], 0.0)
        return acc

    def _layer(self, l: int, H, lay: Layer, w: dict, tf32: bool):
        last = l == 0
        if self.model["kind"] == "gcn":
            deg = lay.keep.sum(dim=1, keepdim=True).to(H.dtype) + 1
            agg = (self._slot_sum(H, lay, lay.keep) + H[lay.pos_self]) / deg
            out = matmul(agg, w[(l, "w")], tf32) + w[(l, "b")]
        else:  # rgcn
            out = matmul(H[lay.pos_self], w[(l, "w_self")], tf32)
            for r in range(self.model["num_relations"]):
                m = lay.keep & (lay.etypes == r)
                cnt = m.sum(dim=1, keepdim=True).clamp(min=1).to(H.dtype)
                out = out + matmul(self._slot_sum(H, lay, m) / cnt, w[(l, "w_rel")][r], tf32)
            out = out + w[(l, "b")]
        return out if last else torch.relu(out)

    def loss(self, feats_of, w: dict, step: int, tf32: bool = False) -> torch.Tensor:
        """The mean cross-entropy of ``step``'s seeds; ``feats_of(ids)``
        returns the input rows of the given ids."""
        layers, F_L = self.frontiers(self.seeds(step), step)
        H = feats_of(F_L)
        for l in reversed(range(len(layers))):
            H = self._layer(l, H, layers[l], w, tf32)
        return F.cross_entropy(H, self.labels[layers[0].dst])

    def train(self, feats_of, w0: dict, steps: int, tf32: bool = False) -> dict:
        """``steps`` steps of Adam from ``w0``: each step's loss, the first
        step's gradients and the weights after the last step."""
        o = self.optim
        w = {k: v.detach().clone().requires_grad_() for k, v in w0.items()}
        m = {k: torch.zeros_like(v) for k, v in w0.items()}
        v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
        losses, first = [], None
        for t in range(1, steps + 1):
            loss = self.loss(feats_of, w, t - 1, tf32)
            grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach() for k, g in grads.items()}
            with torch.no_grad():
                for k, p in w.items():
                    g = grads[k]
                    m[k] = o["beta1"] * m[k] + (1 - o["beta1"]) * g
                    v2[k] = o["beta2"] * v2[k] + (1 - o["beta2"]) * g * g
                    mhat = m[k] / (1 - o["beta1"] ** t)
                    vhat = v2[k] / (1 - o["beta2"] ** t)
                    p -= o["lr"] * mhat / (torch.sqrt(vhat) + o["eps"])
        return {"losses": losses, "grads": first,
                "weights": {k: p.detach() for k, p in w.items()}}

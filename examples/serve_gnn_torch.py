"""Serve live GNN ego-network traffic on the PyTorch port.

    PYTHONPATH=src python examples/serve_gnn_torch.py [--smoke] [--device cpu]

The port's twin of ``serve_gnn.py``, at its configuration: a synthetic
user-item recommendation graph (power-law degrees on both sides) takes
a Poisson stream of user ego-network queries; the server coalesces
concurrent requests into ONE shared minibatch plan per dispatch,
gathers features and scatters per-request predictions back out with
latency accounting.  Prints the policy comparison against the
independent per-request baseline, with the serving step's shape
signatures per bucket (``compiles``, one each).  Runs on the CUDA card
unless ``--device cpu``; on a card cuBLAS may pick another algorithm for
another batch size, so coalesced and per-request predictions agree
within a float32 tolerance there rather than bit for bit.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.data import make_recsys
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve import GNNServer, ServeConfig, poisson_trace


def serve_gnn(smoke: bool = False, requests: int = 400, rate: float = 4000.0,
              device=None) -> dict:
    """Serve at ``serve_gnn.py``'s configuration; returns the reports by
    policy (``"independent"`` for the baseline) and the largest gap
    between coalesced and per-request predictions."""
    if smoke:
        ds = make_recsys(num_users=512, num_items=256, edges_per_user=6,
                         feature_dim=32, seed=0, device=device)
        requests, hidden = min(requests, 80), 64
    else:
        ds = make_recsys(num_users=4096, num_items=1024, seed=0, device=device)
        hidden = 128

    gnn = GNNConfig(model="gcn", num_layers=2, in_dim=ds.feature_dim,
                    hidden_dim=hidden, num_classes=ds.num_classes)
    model = init_gnn(gnn, seed=0, device=device)
    trace = poisson_trace(requests, rate_rps=rate, seed_pool=ds.user_ids, seed=1)
    print(f"graph: |V|={ds.graph.num_vertices} |E|={ds.graph.num_edges} "
          f"({ds.num_users} users / {ds.num_items} items)")
    print(f"trace: {requests} requests @ {rate:.0f} req/s\n")

    base = ServeConfig(num_layers=2, fanout=5, max_batch=64,
                       max_wait_ms=10.0, use_cache=False)
    indep = GNNServer(ds.graph, ds.features, gnn, model, base, device=device)
    rep_i = indep.serve_independent(trace)
    print(f"independent per-request : {rep_i.summary()}")
    reports = {"independent": rep_i}

    ref = None
    for policy in ("max_batch", "max_wait_ms", "hybrid"):
        server = GNNServer(ds.graph, ds.features, gnn, model,
                           dataclasses.replace(base, policy=policy), device=device)
        rep = server.serve_trace(trace)
        reports[policy] = rep
        print(f"coalesced [{policy:<11}]: {rep.summary()}")
        print(f"  fetch reduction vs independent: "
              f"{rep_i.fetched_rows / rep.fetched_rows:.2f}x, "
              f"compiles per bucket: {rep.compiles['serve.forward']}")
        if ref is None:
            ref = {s.request.rid: s.pred for s in rep.served}

    # predictions are bit-identical to per-request inference on the CPU
    ok = all(np.array_equal(ref[s.request.rid], s.pred) for s in rep_i.served)
    gap = max(float(np.abs(ref[s.request.rid] - s.pred).max()) for s in rep_i.served)
    print(f"\ncoalesced == per-request predictions (bit-identical): {ok}")
    return dict(reports=reports, bit_identical=ok, max_abs_diff=gap)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CI sizes")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=4000.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    serve_gnn(smoke=args.smoke, requests=args.requests, rate=args.rate, device=args.device)

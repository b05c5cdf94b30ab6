"""Coalescing GNN inference serving on the port (PyTorch, CUDA by default).

    from repro_torch.data import make_recsys
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.serve import GNNServer, ServeConfig, poisson_trace

    ds = make_recsys()
    gnn_cfg = GNNConfig(num_layers=2)
    model = init_gnn(gnn_cfg, seed=0)
    server = GNNServer(ds.graph, ds.features, gnn_cfg, model,
                       ServeConfig(plan_backend="fused"))
    report = server.serve_trace(
        poisson_trace(500, rate_rps=4000, seed_pool=ds.user_ids))
    print(report.summary())

Layer map: ``queue`` (arrival traces + FIFO queue), ``coalesce``
(admission policies, bucket ladder, seed merging), ``server`` (the
plan/gather/forward loop with latency + fetch accounting).
"""
from repro_torch.serve.coalesce import (
    POLICIES,
    BucketGuard,
    BucketLadder,
    CoalescedBatch,
    Coalescer,
    HybridPolicy,
    MaxBatchPolicy,
    MaxWaitPolicy,
    RetraceError,
    make_policy,
)
from repro_torch.serve.queue import (
    Request,
    RequestQueue,
    bursty_trace,
    make_trace,
    poisson_trace,
)
from repro_torch.serve.server import (
    BatchRecord,
    GNNServer,
    ServeConfig,
    ServedRequest,
    ServeReport,
)

__all__ = [
    "BatchRecord", "BucketGuard", "BucketLadder", "CoalescedBatch", "Coalescer", "GNNServer",
    "HybridPolicy", "MaxBatchPolicy", "MaxWaitPolicy", "POLICIES", "Request",
    "RequestQueue", "RetraceError", "ServeConfig", "ServeReport", "ServedRequest",
    "bursty_trace", "make_policy", "make_trace", "poisson_trace",
]

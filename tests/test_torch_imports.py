"""Boundaries of the PyTorch port (``src/repro_torch``).

* No module of the port, and nothing in ``chip_smoke.py``, imports JAX or
  the JAX package ``repro``: the port keeps its own copies.
* Kernel wrappers take their plain torch version for CPU tensors and
  never reach the CUDA launch path there.
* Entry points default to CUDA and raise, rather than fall back to the
  CPU, when no GPU is present.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import FeatureStore
from repro_torch.kernels import _build
from repro_torch.kernels.expand_indptr import expand_indptr, expand_indptr_cuda, expand_indptr_ref
from repro_torch.kernels.gather import gather, gather_cuda, gather_ref
from repro_torch.kernels.seg_softmax import (
    seg_softmax,
    seg_softmax_backward_cuda,
    seg_softmax_backward_ref,
    seg_softmax_cuda,
    seg_softmax_ref,
)
from repro_torch.kernels.spmm import (
    spmm_backward_cuda,
    spmm_backward_ref,
    spmm_cuda,
    spmm_mean,
    spmm_ref,
    spmm_sum,
)
from repro_torch.kernels.frontier_gather import frontier_gather, frontier_gather_ref
from repro_torch.kernels.unique_compact import unique_with_inverse, unique_with_inverse_ref
from repro_torch.store import probe_ref, tag_probe

torch.set_num_threads(1)  # the suite runs files in parallel workers

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
INVALID = 2**31 - 1


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_has_modules_and_chip_smoke():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "src/repro_torch/serve/server.py",
                 "src/repro_torch/kernels/_build.py", "src/repro_torch/store/kernel.py",
                 "src/repro_torch/train/loop.py", "src/repro_torch/core/cooperative.py",
                 "src/repro_torch/kernels/gather/ops.py", "src/repro_torch/kernels/spmm/ops.py",
                 "src/repro_torch/kernels/seg_softmax/ops.py",
                 "src/repro_torch/kernels/expand_indptr/ops.py"):
        assert want in rel


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_launch(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("CUDA launch path reached for a CPU tensor")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def test_wrappers_take_plain_path_on_cpu(no_launch):
    rng = np.random.default_rng(0)
    indptr = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32)
    indices = torch.tensor([1, 3, 0, 2, 3, 1], dtype=torch.int32)
    seeds = torch.tensor([3, INVALID, 0, 2], dtype=torch.int32)
    got = frontier_gather(indptr, indices, seeds, 3)
    want = frontier_gather_ref(indptr, indices, seeds, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    ids = torch.from_numpy(rng.integers(0, 20, 64).astype(np.int32))
    got = unique_with_inverse(ids, 8)
    want = unique_with_inverse_ref(ids, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    tags = torch.from_numpy(rng.integers(0, 50, (16, 4)).astype(np.int32))
    sets = torch.from_numpy(rng.integers(0, 16, 32).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 50, 32).astype(np.int32))
    assert torch.equal(tag_probe(tags, sets, ids), probe_ref(tags, sets, ids))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_training_wrappers_take_plain_path_on_cpu(no_launch):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    ids = torch.tensor([[3, INVALID, 29], [0, -2, 30]], dtype=torch.int32)
    got = gather(table, ids)
    assert got.shape == (2, 3, 8)
    assert torch.equal(got.reshape(-1, 8), gather_ref(table, ids.reshape(-1)))
    # the store clamps ids other than INVALID into [0, V) first, as the JAX store does
    clamped = torch.where(ids == INVALID, ids, ids.clamp(0, 29))
    assert torch.equal(FeatureStore(table).gather(ids), gather(table, clamped))

    src = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(-1, 30, (12, 5)).astype(np.int32))
    mask = torch.from_numpy(rng.random((12, 5)) < 0.6) & (idx >= 0)
    for fn, mean in ((spmm_sum, False), (spmm_mean, True)):
        out = fn(src, idx, mask)
        assert torch.equal(out.detach(), spmm_ref(src.detach(), idx, mask, mean=mean))
        g = torch.ones_like(out)
        (grad,) = torch.autograd.grad(out, src, g)
        assert torch.equal(grad, spmm_backward_ref(g, idx, mask, 30, mean=mean))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_gat_and_coo_wrappers_take_plain_path_on_cpu(no_launch):
    from repro_torch.core import MinibatchLayer, layer_to_coo

    rng = np.random.default_rng(2)
    e = torch.from_numpy(rng.standard_normal((12, 5, 3)).astype(np.float32)).requires_grad_()
    mask = torch.from_numpy(rng.random((12, 5)) < 0.6)
    alpha = seg_softmax(e, mask)
    assert torch.equal(alpha.detach(), seg_softmax_ref(e.detach(), mask))
    g = torch.from_numpy(rng.standard_normal((12, 5, 3)).astype(np.float32))
    (grad,) = torch.autograd.grad(alpha, e, g)
    assert torch.equal(grad, seg_softmax_backward_ref(alpha.detach(), g, mask))

    indptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    assert torch.equal(expand_indptr(indptr, 7), expand_indptr_ref(indptr, 7))
    idx = torch.from_numpy(rng.integers(0, 9, (12, 5)).astype(np.int32))
    layer = MinibatchLayer(idx[:, 0], idx[:, 0], idx, mask, None)
    got = layer_to_coo(layer, 60, backend="fused")
    want = layer_to_coo(layer, 60, backend="reference")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_wrappers_reject_other_devices():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        frontier_gather(meta, meta, meta, 2)
    with pytest.raises(ValueError):
        unique_with_inverse(meta, 2)
    with pytest.raises(ValueError):
        tag_probe(meta.reshape(2, 2), meta, meta)
    with pytest.raises(ValueError):
        gather(meta.reshape(2, 2).float(), meta)
    with pytest.raises(ValueError):
        spmm_sum(meta.reshape(2, 2).float(), meta.reshape(2, 2), meta.reshape(2, 2).bool())
    with pytest.raises(ValueError):
        seg_softmax(meta.reshape(2, 2).float(), meta.reshape(2, 2).bool())
    with pytest.raises(ValueError):
        expand_indptr(meta, 3)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.frontier_gather import frontier_gather_cuda

    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        frontier_gather_cuda(t, t, t, 2)
    f = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="not CUDA"):
        gather_cuda(f, t)
    with pytest.raises(ValueError, match="not CUDA"):
        spmm_cuda(f, t.reshape(2, 2), t.reshape(2, 2).bool(), mean=False)
    with pytest.raises(ValueError, match="not CUDA"):
        spmm_backward_cuda(f, t.reshape(2, 2), t.reshape(2, 2).bool(), 4, mean=False)
    m = t.reshape(2, 2).bool()
    with pytest.raises(ValueError, match="not CUDA"):
        seg_softmax_cuda(f.reshape(2, 2, 2), m)
    with pytest.raises(ValueError, match="not CUDA"):
        seg_softmax_backward_cuda(f.reshape(2, 2, 2), f.reshape(2, 2, 2), m)
    with pytest.raises(ValueError, match="not CUDA"):
        expand_indptr_cuda(t, 3)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.data import make_recsys
    from repro_torch.device import resolve_device
    from repro_torch.engine import EngineConfig, MinibatchEngine
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.serve import GNNServer, ServeConfig
    from repro_torch.store import TieredFeatureStore

    ds = make_recsys(num_users=64, num_items=32, edges_per_user=3,
                     feature_dim=8, max_degree=16, seed=0, device="cpu")
    cfg = GNNConfig(num_layers=2, in_dim=8, hidden_dim=8, num_classes=4)
    model = init_gnn(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNServer(ds.graph, ds.features, cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MinibatchEngine.from_config(ds.graph, EngineConfig(local_batch=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredFeatureStore(ds.features, capacity=16, ways=4)
    from repro_torch.data import SyntheticGraphDataset, rmat_graph
    from repro_torch.train import TrainConfig, train_gnn

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rmat_graph(scale=5, max_degree=4)
    syn = SyntheticGraphDataset(rmat_graph(scale=5, max_degree=4, device="cpu"),
                                feature_dim=8, num_classes=4)
    tc = TrainConfig(num_pes=2, local_batch=4, fanout=2, num_steps=1, eval_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gnn(syn, cfg, tc)
    # the same calls run when the CPU is asked for
    GNNServer(ds.graph, ds.features, cfg, model, ServeConfig(), device="cpu")
    assert len(train_gnn(syn, cfg, tc, device="cpu").losses) == 1


def test_unported_paths_raise_not_implemented():
    """The multi-device executor still raises; every sampler and model the
    JAX package has now builds (they raised here until they were ported)."""
    from repro_torch.core.samplers import make_sampler
    from repro_torch.data import make_recsys
    from repro_torch.engine import EngineConfig, MinibatchEngine
    from repro_torch.models.gnn import GNN, GNNConfig

    for name in ("ns", "labor0", "labor*", "rw", "full"):
        assert make_sampler(name, fanout=3).name == name
    ds = make_recsys(num_users=64, num_items=32, edges_per_user=3,
                     feature_dim=8, max_degree=16, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MinibatchEngine.from_config(
            ds.graph, EngineConfig(mode="cooperative", num_pes=2, executor="shard"),
            device="cpu",
        )
    for model in ("gcn", "sage", "gat", "rgcn"):
        net = GNN(GNNConfig(model=model, num_layers=2, in_dim=8, hidden_dim=8,
                            num_classes=4, num_heads=2, num_relations=3), device="cpu")
        assert len(net.layers) == 2


def test_build_target_follows_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source, the flags and every shared
    ``*.cuh`` header under the package: editing, adding or removing a header
    names a new library, so no stale build is reused (no ``nvcc`` needed)."""
    pkg = tmp_path / "repro_torch"
    (pkg / "kernels" / "k").mkdir(parents=True)
    src = pkg / "kernels" / "k" / "k.cu"
    src.write_text('#include "../scan.cuh"\n')
    header = pkg / "kernels" / "scan.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "PACKAGE_DIR", pkg)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.sources() == {"k": src}
    first = _build._target(src)
    assert first.parent == tmp_path / "build" and first.name.startswith("k-")
    assert _build._target(src) == first
    header.write_text("// v2\n")
    second = _build._target(src)
    assert second != first
    (pkg / "extra.cuh").write_text("// new\n")
    third = _build._target(src)
    assert third not in (first, second)
    (pkg / "extra.cuh").unlink()
    assert _build._target(src) == second
    src.write_text('#include "../scan.cuh"\n// edited\n')
    assert _build._target(src) not in (first, second, third)


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """Alone in a directory (and here without a card) it exits non-zero
    and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

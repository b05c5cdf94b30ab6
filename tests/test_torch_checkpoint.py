"""Checkpoints and utilities of the port vs the JAX package.

* A JAX ``save_checkpoint`` of ``init_gnn(PRNGKey(0), cfg)`` loads into the
  port with equal tensors, and a port checkpoint loads through the JAX
  ``load_checkpoint(like=...)`` with equal arrays, for the GCN, GraphSAGE,
  GAT and R-GCN; both write the same keys and ``extra`` metadata.
* A checkpoint of another structure raises ``ValueError`` (the JAX code
  asserts).
* ``Timer``, ``bench_fn`` and ``get_logger`` (a ``repro_torch`` root logger
  whose level comes from ``REPRO_LOG_LEVEL``).
"""
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.train.checkpoint import load_checkpoint as j_load
from repro.train.checkpoint import save_checkpoint as j_save
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.train import load_checkpoint, save_checkpoint
from repro_torch.utils import Timer, bench_fn, get_logger

torch.set_num_threads(1)  # the suite runs files in parallel workers

ROOT = Path(__file__).resolve().parents[1]
MODELS = {
    "gcn": dict(),
    "sage": dict(),
    "gat": dict(num_heads=2),
    "rgcn": dict(num_relations=3),
}


def _cfgs(model, num_layers=2):
    kw = dict(model=model, num_layers=num_layers, in_dim=8, hidden_dim=12, num_classes=4,
              **MODELS[model])
    return JGNNConfig(**kw), GNNConfig(**kw)


def _port_arrays(model):
    return {f"layers/{l}/{n}": p.detach().numpy()
            for l, layer in enumerate(model.layers) for n, p in layer.named_parameters()}


@pytest.mark.parametrize("model", list(MODELS))
def test_jax_checkpoint_loads_into_port(tmp_path, model):
    jcfg, cfg = _cfgs(model)
    params = j_init_gnn(jax.random.PRNGKey(0), jcfg)
    j_save(str(tmp_path / "ck"), params, extra={"step": 3})
    like = init_gnn(cfg, seed=1, device="cpu")  # other weights, same structure
    got = load_checkpoint(str(tmp_path / "ck"), like)
    arrays = _port_arrays(got)
    for l, layer in enumerate(params["layers"]):
        for name, leaf in layer.items():
            np.testing.assert_array_equal(arrays[f"layers/{l}/{name}"], np.asarray(leaf))
    assert got is not like and got.cfg == cfg
    ref = _port_arrays(init_gnn(cfg, seed=0, device="cpu"))  # the same weights drawn here
    assert all(np.array_equal(ref[k], v) for k, v in arrays.items())


@pytest.mark.parametrize("model", list(MODELS))
def test_port_checkpoint_loads_into_jax(tmp_path, model):
    jcfg, cfg = _cfgs(model)
    net = init_gnn(cfg, seed=2, device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.25)  # not an init: biases are nonzero too
    save_checkpoint(str(tmp_path / "port" / "ck.npz"), net, extra={"step": 3})
    j_save(str(tmp_path / "jax" / "ck.npz"), j_init_gnn(jax.random.PRNGKey(0), jcfg),
           extra={"step": 3})
    got = j_load(str(tmp_path / "port" / "ck.npz"), like=j_init_gnn(jax.random.PRNGKey(1), jcfg))
    arrays = _port_arrays(net)
    for l, layer in enumerate(got["layers"]):
        for name, leaf in layer.items():
            np.testing.assert_array_equal(np.asarray(leaf), arrays[f"layers/{l}/{name}"])
            assert np.asarray(leaf).dtype == np.float32
    port_meta = json.loads((tmp_path / "port" / "ck.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "ck.json").read_text())
    assert port_meta == jax_meta
    assert port_meta["extra"] == {"step": 3}
    again = load_checkpoint(str(tmp_path / "port" / "ck.npz"), net)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), net.parameters()))


def test_structure_mismatch_raises(tmp_path):
    _, cfg2 = _cfgs("gcn", num_layers=2)
    _, cfg3 = _cfgs("gcn", num_layers=3)
    save_checkpoint(str(tmp_path / "ck"), init_gnn(cfg2, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path / "ck"), init_gnn(cfg3, device="cpu"))
    _, sage = _cfgs("sage")
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path / "ck"), init_gnn(sage, device="cpu"))
    wide = GNNConfig(model="gcn", num_layers=2, in_dim=8, hidden_dim=16, num_classes=4)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "ck"), init_gnn(wide, device="cpu"))


def test_timer_and_bench_fn():
    t = Timer("x")
    for _ in range(3):
        with t:
            sum(range(1000))
    assert t.count == 3 and t.total_s > 0 and t.mean_us > 0
    t.reset()
    assert (t.count, t.total_s, t.mean_us) == (0, 0.0, 0.0)
    calls = []
    us = bench_fn(lambda a: calls.append(a) or torch.ones(4) * a, 2.0, warmup=2, iters=3)
    assert us > 0 and len(calls) == 5
    assert bench_fn(lambda: (torch.zeros(2), {"k": [torch.ones(1)]}), iters=1) > 0


def test_get_logger_under_repro_torch_root():
    log = get_logger("stream")
    assert log.name == "repro_torch.stream"
    assert get_logger("repro_torch.store").name == "repro_torch.store"
    root = logging.getLogger("repro_torch")
    assert root.handlers and root.propagate is False
    code = ("import logging; from repro_torch.utils import get_logger; "
            "get_logger('x'); print(logging.getLogger('repro_torch').level)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  REPRO_LOG_LEVEL="debug"))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == logging.DEBUG

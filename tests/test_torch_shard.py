"""Multi-process cooperative execution of the port (``executor="shard"``).

Four ranks of a ``torch.distributed`` gloo process group on the CPU, one
PE each, run ``ShardRunner`` and ``train_gnn(executor="shard")``; their
results are held against the port's ``SimExecutor`` and the JAX
package's (the reference's own ``tests/test_coop_shard.py`` oracle: its
``SimExecutor`` plan and ``jax.value_and_grad(make_loss_fn(...))``).

* Integer plan leaves of every rank equal row ``p`` of both
  ``SimExecutor`` plans bit for bit at steps 0–2, for (``smoothed``,
  κ = 3, ``hash``) and (``nested``, κ = 2, ``degree``); ``stack_plan``
  gives the whole stacked plan and its ``plan_stats``.
* Loss and gradients at steps 0–3 within ``rtol=5e-6`` (loss) and
  ``atol=5e-6, rtol=1e-4`` (gradients) of the JAX package's, equal on
  every rank.
* One Adam step within ``atol=1e-6`` of the simulated step, the ranks'
  weights equal bit for bit.
* All-to-all conservation: rows sent = rows resolved, bucket keys are
  owners, and an all-ones ``redistribute`` across the ranks fills exactly
  the requested rows.
* The shard executor's ``redistribute`` is the padded composition (gather,
  all-to-all, scatter): drawn rows through each layer equal
  ``tests/_padded_exchange.py`` on the stacked plan bit for bit, their
  gradients within ``atol=1e-6``.
* ``train_gnn`` over 4 steps, shard against sim, within ``rtol=1e-5``;
  through the step program (eager under gloo) against the same program
  with stage times (its spans read every step) bit for bit, and within ``rtol=1e-5`` of the JAX package's
  simulated ``train_gnn``.
* ``plan_at`` (the device RNG state) against the host-state build, bit
  for bit.
* The errors: an independent or ``sim`` engine, a world size other than
  ``num_pes`` (the message names torchrun), ``build_plan`` under shard,
  ``stats()`` of a rank's own plan,
  a backend other than the group's, and no card when the rank's device
  is left to default to CUDA.
* The torchrun launcher, shard against sim.

The ranks run once per module in subprocesses (a ``FileStore`` in a temp
dir, no port), each writing its results to that dir; every spawn and
``init_process_group`` has a timeout.  Size: the reference test's own,
``rmat_graph(scale=10, edge_factor=8, max_degree=32)``, 16 features, 8
classes, P = 4, b = 16, L = 2, fanout 5, a GCN with hidden 32.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import rmat_graph as j_rmat_graph
from repro.data.synthetic import SyntheticGraphDataset as JDataset
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MinibatchEngine as JEngine
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import init_gnn as j_init_gnn
from repro.train import loop as jloop
from repro.train.optim import adam_init as j_adam_init
from repro.train.optim import adam_update as j_adam_update
from repro_torch.core.cooperative import SimExecutor, redistribute
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import TrainConfig, train_gnn
from _padded_exchange import padded_chain

torch.set_num_threads(1)  # the suite runs files in parallel workers

ROOT = Path(__file__).resolve().parents[1]
P, B, L = 4, 16, 2
GNN = dict(model="gcn", num_layers=L, in_dim=16, hidden_dim=32, num_classes=8)
PLAN_CASES = {"smoothed": ("smoothed", 3, "hash"), "nested": ("nested", 2, "degree")}
PLAN_STEPS, GRAD_STEPS, TRAIN_STEPS = 3, 4, 4
RANK_TIMEOUT_S = 240
LEAF_NAMES = ("seeds", "self_idx", "nbr_idx", "mask", "etypes", "slot_to_tilde", "req_idx",
              "tilde_ids")

# One rank: argv = rank, FileStore path, output dir.  Everything it computes
# goes to <dir>/rank<r>.pkl as numpy arrays and strings.
_RANK = textwrap.dedent(
    """
    import dataclasses, datetime, pickle, sys
    import numpy as np, torch, torch.distributed as dist

    rank, store, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    P, B, L = 4, 16, 2
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.core.cooperative import build_cooperative_minibatch, redistribute
    from repro_torch.data import SyntheticGraphDataset, rmat_graph
    from repro_torch.engine import EngineConfig, MinibatchEngine
    from repro_torch.engine.shard import ShardRunner
    from repro_torch.launch import make_coop_group
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.train import TrainConfig, adam_init, adam_update, train_gnn

    g = rmat_graph(scale=10, edge_factor=8, max_degree=32, seed=0, device="cpu")
    ds = SyntheticGraphDataset(g, feature_dim=16, num_classes=8, seed=0)
    gnn_cfg = GNNConfig(model="gcn", num_layers=L, in_dim=16, hidden_dim=32, num_classes=8)
    out = {"errors": {}}

    def engine(schedule, kappa, partition, **kw):
        cfg = EngineConfig(mode="cooperative", num_pes=P, local_batch=B, num_layers=L,
                           sampler="labor0", fanout=5, schedule=schedule, kappa=kappa,
                           partition=partition, seed=7, executor="shard")
        return MinibatchEngine.from_config(g, dataclasses.replace(cfg, **kw), dataset=ds,
                                           device="cpu")

    def leaves(plan):
        d = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
        for l, layer in enumerate(plan.layers):
            for f in dataclasses.fields(layer):
                if getattr(layer, f.name) is not None:
                    d[f"{f.name}{l}"] = getattr(layer, f.name)
        return {k: v.numpy() for k, v in d.items()}

    # plans, local and stacked
    for tag, (schedule, kappa, partition) in {"smoothed": ("smoothed", 3, "hash"),
                                              "nested": ("nested", 2, "degree")}.items():
        sh = engine(schedule, kappa, partition)
        for step in range(3):
            local = sh.plan_at(step)
            stacked = sh.shard_runner.stack_plan(local)
            out[f"plan/{tag}/{step}"] = leaves(local)
            out[f"stacked/{tag}/{step}"] = leaves(stacked)
            out[f"stats/{tag}/{step}"] = stacked.stats()
            # the same rank's build from the host RNG state and host seed row
            host = build_cooperative_minibatch(
                sh.graph, sh.sampler, sh.part, sh._seed_batch(step)[rank], sh.rng_state(step),
                L, sh.caps, sh.shard_runner.ex, backend=sh.config.plan_backend)
            out[f"hostplan/{tag}/{step}"] = leaves(host)

    # loss and all-reduced gradients from the JAX package's initial weights
    sh = engine("smoothed", 3, "degree")
    runner = sh.shard_runner
    lg = runner.make_loss_and_grad(gnn_cfg, ds.features, ds.labels)
    model = init_gnn(gnn_cfg, seed=0, device="cpu")
    for step in range(4):
        loss, grads = lg(model, step)
        out[f"loss/{step}"] = float(loss)
        out[f"grads/{step}"] = [gr.numpy().copy() for gr in grads]

    # one Adam step
    opt = adam_init(model)
    _, grads = lg(model, 0)
    adam_update(list(model.parameters()), grads, opt, lr=1e-3)
    out["adam"] = [p.detach().numpy().copy() for p in model.parameters()]

    # conservation: the stacked step-0 plan, and all-ones rows through the
    # exchange across the ranks
    local = sh.plan_at(0)
    out["conserve_plan"] = leaves(runner.stack_plan(local))
    out["owner"] = sh.part.owner.numpy()
    ones = torch.ones(local.input_ids.shape + (4,))
    out["ones_tilde"] = redistribute(runner.ex, local.layers[L - 1], ones,
                                     sh.caps.tilde_caps[L - 1]).numpy()
    # drawn rows through each layer's exchange, and their gradients
    gen = torch.Generator().manual_seed(100 + rank)
    out["drawn"] = []
    for l in range(L):
        rows = (local.input_ids if l == L - 1 else local.layers[l + 1].seeds).shape[0]
        H = torch.randn((rows, 6), generator=gen).requires_grad_(True)
        G = torch.randn((sh.caps.tilde_caps[l], 6), generator=gen)
        y = redistribute(runner.ex, local.layers[l], H, sh.caps.tilde_caps[l])
        (gh,) = torch.autograd.grad((y * G).sum(), H)
        out["drawn"].append({k: v.detach().numpy() for k, v in
                             {"H": H, "G": G, "out": y, "grad": gh}.items()})

    # train_gnn with the shard executor, stage times and exchanges from the spans
    tc = TrainConfig(mode="cooperative", num_pes=P, local_batch=B, num_steps=4,
                     schedule="smoothed", kappa=3, partition="degree", executor="shard",
                     eval_every=0)
    plans = {"staged": [], "program": []}
    res = train_gnn(ds, gnn_cfg, tc, device="cpu", stage_times=True,
                    on_step=lambda step, plan: plans["staged"].append(leaves(plan)))
    out["train_losses"] = res.losses
    out["train_stages"] = [sorted(s) for s in res.stage_ms]
    out["train_exchanges"] = [{k: v[:2] for k, v in e.items()} for e in res.exchanges]
    out["train_weights"] = [p.detach().numpy().copy() for p in res.model.parameters()]
    # the same steps through the step program (eager under gloo)
    res = train_gnn(ds, gnn_cfg, tc, device="cpu",
                    on_step=lambda step, plan: plans["program"].append(leaves(plan)))
    out["program_losses"] = res.losses
    out["program_weights"] = [p.detach().numpy().copy() for p in res.model.parameters()]
    out["program_stages"] = (res.stage_ms, res.exchanges, res.compiled)
    out["train_plans"] = plans

    # the errors
    def error(key, fn):
        try:
            fn()
        except ValueError as e:
            out["errors"][key] = str(e)

    error("world_size", lambda: engine("smoothed", 3, "hash", num_pes=2))
    error("independent", lambda: ShardRunner.for_engine(
        engine("iid", 1, "hash", mode="independent", executor="sim")))
    error("sim", lambda: ShardRunner.for_engine(engine("smoothed", 3, "hash", executor="sim")))
    error("build_plan", lambda: sh.build_plan(sh.seed_batch(0)))
    error("stats", lambda: local.stats())  # a rank's own plan has no global view
    error("backend", lambda: make_coop_group(P, "nccl", device="cpu"))
    torch.cuda.is_available = lambda: False  # as on a host without a card
    try:
        make_coop_group(P)  # the rank's device defaults to CUDA
    except RuntimeError as e:
        out["errors"]["no_cuda"] = str(e)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    """
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run_all(cmds, cwd, timeout_s: float):
    """Run the commands side by side; kill every one of them if any fails or
    the deadline passes.  Returns their stdout."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert p.returncode == 0, f"{p.args[:4]} exited {p.returncode}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (a list of P dicts), from one run of P processes."""
    d = tmp_path_factory.mktemp("shard")
    _run_all([[sys.executable, "-c", _RANK, str(r), str(d / "store"), str(d)]
              for r in range(P)], d, RANK_TIMEOUT_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))  # written by the ranks above
    return out


@pytest.fixture(scope="module")
def datasets():
    jg = j_rmat_graph(scale=10, edge_factor=8, max_degree=32, seed=0)
    jds = JDataset(jg, feature_dim=16, num_classes=8, seed=0)
    tds = SyntheticGraphDataset(rmat_graph(scale=10, edge_factor=8, max_degree=32, seed=0,
                                           device="cpu"),
                                feature_dim=16, num_classes=8, seed=0)
    return jds, tds


def _cfg(schedule, kappa, partition):
    return dict(mode="cooperative", num_pes=P, local_batch=B, num_layers=L, sampler="labor0",
                fanout=5, schedule=schedule, kappa=kappa, partition=partition, seed=7)


def _leaves(plan) -> dict:
    """Integer leaves of a plan (JAX or port, stacked) as numpy, by name."""
    d = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in LEAF_NAMES:
            if getattr(layer, name) is not None:
                d[f"{name}{l}"] = getattr(layer, name)
    return {k: np.asarray(v) for k, v in d.items()}


def _jparams():
    return j_init_gnn(jax.random.PRNGKey(0), JGNNConfig(**GNN))


def _jflat(tree):
    """JAX-layout leaves in the port's ``model.parameters()`` order (the
    port's layers hold ``w`` then ``b``, as ``named_parameters`` lists them)."""
    from repro_torch.models.gnn import init_gnn

    model = init_gnn(GNNConfig(**GNN), seed=0, device="cpu")
    return [np.asarray(tree["layers"][l][name]) for l, layer in enumerate(model.layers)
            for name, _ in layer.named_parameters()]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_rank_plans_equal_sim_rows(ranks, datasets, case):
    jds, tds = datasets
    cfg = _cfg(*PLAN_CASES[case])
    je = JEngine.from_config(jds.graph, JEngineConfig(**cfg), dataset=jds)
    te = MinibatchEngine.from_config(tds.graph, EngineConfig(**cfg), dataset=tds, device="cpu")
    for step in range(PLAN_STEPS):
        want_j = _leaves(je.plan_at(step))
        sim = te.plan_at(step)
        want_t = _leaves(sim)
        assert set(want_j) == set(want_t)
        for name, w in want_j.items():
            np.testing.assert_array_equal(want_t[name], w, err_msg=f"sim {name} step {step}")
        for p, got in enumerate(ranks):
            local, stacked = got[f"plan/{case}/{step}"], got[f"stacked/{case}/{step}"]
            assert set(local) == set(stacked) == set(want_j)
            for name, w in want_j.items():
                assert local[name].dtype == want_t[name].dtype, name
                np.testing.assert_array_equal(local[name], w[p], err_msg=f"rank {p} {name}")
                np.testing.assert_array_equal(stacked[name], w, err_msg=f"stacked {name}")
            assert got[f"stats/{case}/{step}"] == sim.stats()


def test_loss_and_grads_match_jax_sim(ranks, datasets):
    jds, _ = datasets
    je = JEngine.from_config(jds.graph, JEngineConfig(**_cfg("smoothed", 3, "degree")),
                             dataset=jds)
    lg = jax.jit(jax.value_and_grad(
        jloop.make_loss_fn(je, JGNNConfig(**GNN), je.store, jds.labels)))
    params = _jparams()
    for step in range(GRAD_STEPS):
        jl, jg = lg(params, jnp.int32(step))
        want = _jflat(jg)
        for p, got in enumerate(ranks):
            np.testing.assert_allclose(got[f"loss/{step}"], float(jl), rtol=5e-6)
            assert len(got[f"grads/{step}"]) == len(want)
            for i, (g, w) in enumerate(zip(got[f"grads/{step}"], want)):
                assert float(np.abs(w).max()) > 0
                np.testing.assert_allclose(g, w, atol=5e-6, rtol=1e-4,
                                           err_msg=f"rank {p} step {step} grad {i}")
                np.testing.assert_array_equal(g, ranks[0][f"grads/{step}"][i])
            assert got[f"loss/{step}"] == ranks[0][f"loss/{step}"]


def test_adam_step_in_lockstep(ranks, datasets):
    jds, _ = datasets
    je = JEngine.from_config(jds.graph, JEngineConfig(**_cfg("smoothed", 3, "degree")),
                             dataset=jds)
    params = _jparams()
    _, grads = jax.value_and_grad(
        jloop.make_loss_fn(je, JGNNConfig(**GNN), je.store, jds.labels))(params, jnp.int32(0))
    want = _jflat(j_adam_update(params, grads, j_adam_init(params), lr=1e-3)[0])
    for p, got in enumerate(ranks):
        for i, (a, w) in enumerate(zip(got["adam"], want)):
            np.testing.assert_allclose(a, w, atol=1e-6, err_msg=f"rank {p} param {i}")
            np.testing.assert_array_equal(a, ranks[0]["adam"][i])


def test_all_to_all_conservation(ranks, datasets):
    _, tds = datasets
    plan, owner = ranks[0]["conserve_plan"], ranks[0]["owner"]
    for l in range(L):
        sent = plan[f"slot_to_tilde{l}"] >= 0        # (P, Q, cap_b)
        resolved = plan[f"req_idx{l}"] >= 0          # (Q, P, cap_b)
        np.testing.assert_array_equal(sent, resolved.swapaxes(0, 1))
        tilde, s2t = plan[f"tilde_ids{l}"], plan[f"slot_to_tilde{l}"]
        for p in range(P):
            for q in range(P):
                ids = tilde[p][s2t[p, q][sent[p, q]]]
                assert (owner[ids] == q).all(), (l, p, q)
                # each request resolves to that id's row in q's next frontier
                nxt = plan[f"seeds{l + 1}"] if l + 1 < L else plan["input_ids"]
                rows = plan[f"req_idx{l}"][q, p][resolved[q, p]]
                np.testing.assert_array_equal(nxt[q][rows], ids)
    # all-ones rows through the exchange across the ranks: one nonzero row
    # per filled tilde slot, none elsewhere, as the SimExecutor's
    s2t = plan[f"slot_to_tilde{L - 1}"]
    te = MinibatchEngine.from_config(tds.graph, EngineConfig(**_cfg("smoothed", 3, "degree")),
                                     dataset=tds, device="cpu")
    sim_plan = te.plan_at(0)
    sim = redistribute(SimExecutor(P), sim_plan.layers[L - 1],
                       torch.ones(sim_plan.input_ids.shape + (4,)), te.caps.tilde_caps[L - 1])
    for p, got in enumerate(ranks):
        want = np.zeros(got["ones_tilde"].shape[0], bool)
        want[s2t[p][s2t[p] >= 0]] = True
        np.testing.assert_array_equal(np.any(got["ones_tilde"] != 0, axis=-1), want)
        np.testing.assert_array_equal(got["ones_tilde"], sim[p].numpy())


def test_shard_redistribute_is_the_padded_chain(ranks):
    """The shard executor keeps the gather, all-to-all and scatter: each
    rank's rows and gradients equal the padded composition's on the
    stacked plan (rows bit for bit)."""
    plan = ranks[0]["conserve_plan"]
    for l in range(L):
        layer = SimpleNamespace(**{k: torch.from_numpy(plan[f"{k}{l}"])
                                   for k in ("slot_to_tilde", "req_idx")})
        drawn = [r["drawn"][l] for r in ranks]
        H = torch.from_numpy(np.stack([d["H"] for d in drawn])).requires_grad_(True)
        G = torch.from_numpy(np.stack([d["G"] for d in drawn]))
        want = padded_chain(P, layer, H, G.shape[1])
        (g,) = torch.autograd.grad((want * G).sum(), H)
        for p, d in enumerate(drawn):
            np.testing.assert_array_equal(d["out"], want[p].detach().numpy())
            np.testing.assert_allclose(d["grad"], g[p].numpy(), rtol=0, atol=1e-6)


def test_train_gnn_shard_matches_sim(ranks, datasets):
    _, tds = datasets
    tc = TrainConfig(mode="cooperative", num_pes=P, local_batch=B, num_steps=TRAIN_STEPS,
                     schedule="smoothed", kappa=3, partition="degree", executor="sim",
                     eval_every=0)
    sim = train_gnn(tds, GNNConfig(**GNN), tc, device="cpu")
    for p, got in enumerate(ranks):
        np.testing.assert_allclose(got["train_losses"], sim.losses, rtol=1e-5)
        assert got["train_losses"] == ranks[0]["train_losses"]
        for a, b in zip(got["train_weights"], ranks[0]["train_weights"]):
            np.testing.assert_array_equal(a, b)
        assert got["train_stages"] == [sorted(
            ("plan", "gather", "forward_backward", "all_reduce", "adam"))] * TRAIN_STEPS
        # L id exchanges and L embedding exchanges a step, L - 1 gradient
        # exchanges (the deepest layer's input is the raw features)
        for e in got["train_exchanges"]:
            assert [e[k][0] for k in ("ids", "forward", "backward")] == [L, L, L - 1]
            assert e["forward"][1] > e["ids"][1] > 0
    assert len(set(np.round(sim.losses, 4))) > 1  # the weights moved


def test_plan_at_from_device_state_equals_host_state_build(ranks):
    """``ShardRunner.plan_at`` (the device state buffer, the device seed
    draw) against the rank's build from the host ``RNGState``: bit for bit."""
    for p, got in enumerate(ranks):
        for case in PLAN_CASES:
            for step in range(PLAN_STEPS):
                local, host = got[f"plan/{case}/{step}"], got[f"hostplan/{case}/{step}"]
                assert set(local) == set(host)
                for name, w in host.items():
                    assert local[name].dtype == w.dtype, name
                    np.testing.assert_array_equal(local[name], w,
                                                  err_msg=f"rank {p} {case} {step} {name}")


def test_train_gnn_shard_program_equals_staged_step(ranks, datasets):
    """``train_gnn`` under the shard executor through the step program
    (eager under gloo) against the same program with its spans read after
    every step (``stage_times=True``): plans, losses and weights bit for
    bit over 4 steps; losses within
    ``rtol=1e-5`` of the JAX package's simulated ``train_gnn``."""
    jds, _ = datasets
    want = jloop.train_gnn(jds, JGNNConfig(**GNN), jloop.TrainConfig(
        mode="cooperative", num_pes=P, local_batch=B, num_steps=TRAIN_STEPS,
        schedule="smoothed", kappa=3, partition="degree", eval_every=0)).losses
    for p, got in enumerate(ranks):
        assert got["program_losses"] == got["train_losses"]
        for a, b in zip(got["program_weights"], got["train_weights"], strict=True):
            np.testing.assert_array_equal(a, b)
        staged, program = got["train_plans"]["staged"], got["train_plans"]["program"]
        assert len(staged) == len(program) == TRAIN_STEPS
        for step, (a, b) in enumerate(zip(program, staged)):
            assert set(a) == set(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=f"rank {p} step {step} {name}")
        # the program keeps no stage times, exchange records or capture
        assert got["program_stages"] == ([], [], {})
        np.testing.assert_allclose(got["program_losses"], want, rtol=1e-5)


def test_errors(ranks):
    for got in ranks:
        err = got["errors"]
        assert set(err) == {"world_size", "independent", "sim", "build_plan", "stats",
                            "backend", "no_cuda"}
        assert "torchrun --nproc-per-node=2" in err["world_size"]
        assert "cooperative" in err["independent"]
        assert "executor='shard'" in err["sim"]
        assert "plan_at" in err["build_plan"]
        assert "stacked SimExecutor layout" in err["stats"]
        assert "runs 'gloo'" in err["backend"]
        assert "device='cpu'" in err["no_cuda"]


def test_shard_engine_needs_a_process_group(datasets):
    _, tds = datasets
    cfg = EngineConfig(**_cfg("smoothed", 3, "hash"), executor="shard")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=4"):
        MinibatchEngine.from_config(tds.graph, cfg, dataset=tds, device="cpu")


def _launcher_losses(stdout: str) -> list:
    return [float(line.split()[-1]) for line in stdout.splitlines()
            if line.startswith("step ") and "loss" in line]


def test_torchrun_launcher_shard_matches_sim(tmp_path):
    args = ["gnn", "--pes", "4", "--scale", "10", "--steps", "2", "--device", "cpu"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node=4", "-m", "repro_torch.launch.train"]
    shard, sim = _run_all([torchrun + args + ["--executor", "shard"],
                           [sys.executable, "-m", "repro_torch.launch.train", *args,
                            "--executor", "sim"]], tmp_path, RANK_TIMEOUT_S)
    got, want = _launcher_losses(shard), _launcher_losses(sim)
    assert len(want) == 2 and len(got) == 2  # rank 0 prints
    np.testing.assert_allclose(got, want, rtol=1e-5)

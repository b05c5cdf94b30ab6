"""The port's compiled programs on the CPU, against the JAX package.

On a card ``plan_at`` and the server's per-bucket steps run as captured
CUDA graphs (``repro_torch.engine.compiled``); the CPU runs the same
device-state code eagerly.  Held here:

* the tensor form of the RNG state (``DeviceRNGState``) gives the scalar
  form's bits and jitted JAX's for every ``c = i / kappa``, kappa <= 64,
  and, at ``c = 0``, the NaN of a second-seed hash at or above
  ``2**32 - 128`` exactly where the dropped ``c == 0`` branch gave it;
* ``plan_at`` on the device state equals the JAX package's jitted
  ``plan_at`` in both modes, for ``labor0``/``ns``/``rw``/``full``, under
  the ``iid``, ``smoothed`` and ``nested`` schedules, at steps across a
  kappa window, seeds included;
* the analyzer's trace pass over ``plan_at`` finds no host sync and one
  op sequence across a ``c = 0`` and a ``c > 0`` step;
* ``CompiledFunction``: ``RetraceError`` on a second signature,
  ``compiles`` per key, and eager only by configuration;
* stream items resolve their seeds lazily, equal to ``seed_batch``;
* the GNN train step as one program (``train.step_program``, eager here):
  Adam with its step on the device bit for bit with the JAX package's over
  20 steps, and ``train_gnn``'s losses and weights through the program
  against the JAX ``train_gnn``; a second signature under one key raises
  ``RetraceError`` (the train step's and the tiered store's programs);
* the LM decode program (``models.transformer.decode_step``): the state
  written in place, prefill and greedy tokens equal to the JAX package's
  jitted ``prefill_decode`` and serve step (``examples/serve_lm.py``'s
  calls) on an attention + SSM hybrid with ring caches.

Small size: ``rmat_graph(scale=9)``, 2 PEs, local batch 8, 2 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MinibatchEngine as JEngine
from repro_torch.analysis.findings import Severity
from repro_torch.analysis.trace import TraceEntry, record_call, run_trace
from repro_torch.core import rng as trng
from repro_torch.data import SyntheticGraphDataset, rmat_graph
from repro_torch.engine import EngineConfig, MinibatchEngine
from repro_torch.engine.compiled import CompiledFunction, RetraceError, shape_signature
from repro_torch.engine.stream import HostRows

torch.set_num_threads(1)  # the suite runs files in parallel workers

_GOLDEN, _SALT = 0x9E3779B9, 0x85EBCA6B
_M = 0xFFFFFFFF


def _unmix(x: int) -> int:
    """Inverse of ``rng._mix`` on one uint32."""
    x ^= x >> 16
    x = (x * pow(0x846CA68B, -1, 1 << 32)) & _M
    x ^= (x >> 15) ^ (x >> 30)
    x = (x * pow(0x7FEB352D, -1, 1 << 32)) & _M
    return x ^ (x >> 16)


def _ids_hashing_to(hashes, seed: int, salt: int) -> np.ndarray:
    """uint32 ids whose ``hash_u32`` under ``(seed, salt)`` is each of ``hashes``."""
    s, t = (seed * _GOLDEN) & _M, (salt * _SALT) & _M
    return np.asarray([_unmix(_unmix(h) ^ t) ^ s for h in hashes], np.uint32)


def _cs():
    """Every interpolation coefficient ``c = i / kappa`` for kappa <= 64."""
    return sorted({float(np.float32(i) / np.float32(k)) for k in range(1, 65) for i in range(k)})


Z1, Z2, SALT = 12345, 12346, 2


@pytest.fixture(scope="module")
def rng_ids():
    """1,024 spread ids, then 128 ids whose hash under ``Z2`` is at or above
    ``2**32 - 128`` (their uniform rounds to 1.0, their normal is inf)."""
    spread = (np.arange(1024, dtype=np.int64) * 2654435761) & _M
    top = _ids_hashing_to(range(2**32 - 128, 2**32), Z2, SALT).astype(np.int64)
    got = trng.hash_u32(torch.from_numpy(top), Z2, SALT)
    assert int(got.min()) >= 2**32 - 128
    return np.concatenate([spread, top])


def test_hash_takes_a_device_seed_and_salt(rng_ids):
    ids = torch.from_numpy(rng_ids)
    want = trng.hash_u32(ids, Z1, SALT)
    for seed, salt in ((torch.tensor(Z1), SALT), (Z1, torch.tensor(SALT)),
                       (torch.tensor(Z1), torch.tensor([[SALT]]))):
        assert torch.equal(trng.hash_u32(ids, seed, salt).reshape(-1), want)
    st = trng.RNGState(Z1, Z2, 0.25)
    dev = trng.DeviceRNGState.pack(st)
    for salt in (0, 1000, 2**31 + 5):
        assert int(dev.fold(salt)) == st.fold(salt)
    assert trng.mix_int(0xDEADBEEF) == int(trng._mix(torch.tensor(0xDEADBEEF)))


def test_tensor_rng_bit_equal_to_scalar_and_jitted_jax(rng_ids):
    """Every ``c = i / kappa`` (kappa <= 64): the device-state variates equal
    the scalar form's and ``jax.jit``'s with the state traced, bit for bit,
    NaNs included."""
    ids_t = torch.from_numpy(rng_ids)
    other = torch.from_numpy(rng_ids[::-1].copy())
    ids_j = jnp.asarray(rng_ids.astype(np.uint32))
    other_j = jnp.asarray(rng_ids[::-1].astype(np.uint32))

    @jax.jit
    def jax_variates(i, o, c):  # ids as arguments: constants would be folded
        st = jrng.RNGState(jnp.uint32(Z1), jnp.uint32(Z2), c)
        return st.vertex_uniform(i, SALT), st.edge_uniform(i, o, SALT)

    for c in _cs():
        scalar = trng.RNGState(Z1, Z2, c)
        dev = trng.DeviceRNGState.pack(scalar)
        wv, we = (np.asarray(x) for x in jax_variates(ids_j, other_j, jnp.float32(c)))
        for form in (scalar, dev):
            v = form.vertex_uniform(ids_t, SALT).numpy()
            e = form.edge_uniform(ids_t, other, SALT).numpy()
            assert v.dtype == e.dtype == np.float32
            np.testing.assert_array_equal(v, wv, err_msg=f"vertex c={c} {type(form).__name__}")
            np.testing.assert_array_equal(e, we, err_msg=f"edge c={c} {type(form).__name__}")


def test_no_c0_branch_gives_the_branch_bits(rng_ids):
    """At ``c = 0`` ``fma(n1, cosf(0), sinf(0) * n2)`` is ``n1`` and NaN
    exactly where ``n2`` is infinite: the dropped branch
    ``ndtr(where(u2 >= 1, nan, n1))``, bit for bit, in both forms."""
    ids = torch.from_numpy(rng_ids)
    assert trng._cos_sin_half_pi(0.0) == (1.0, 0.0)
    n1 = trng.normal_from_ids(ids, Z1, SALT)
    u2 = trng.uniform_from_ids(ids, Z2, SALT)
    branch = trng.ndtr(torch.where(u2 >= 1.0, torch.nan, n1)).numpy()
    nan = np.isnan(branch)
    assert nan.sum() == 128 and nan[-128:].all()
    for form in (trng.RNGState(Z1, Z2, 0.0),
                 trng.DeviceRNGState.pack(trng.RNGState(Z1, Z2, 0.0))):
        np.testing.assert_array_equal(form.vertex_uniform(ids, SALT).numpy(), branch)
    # a signed zero into ndtr gives 0.5 either way
    assert trng.ndtr(torch.tensor([0.0, -0.0])).tolist() == [0.5, 0.5]


# --------------------------------------------------------------------------
# plan_at on the device state against the JAX package
# --------------------------------------------------------------------------
SCHEDULES = {"iid": (1, (0, 1, 2)), "smoothed": (4, (0, 3, 4, 5)), "nested": (4, (0, 3, 4, 9))}


@pytest.fixture(scope="module")
def graphs():
    from repro.data import SyntheticGraphDataset as JDataset
    from repro.data import rmat_graph as j_rmat

    kw = dict(scale=9, edge_factor=8, max_degree=16, seed=0)
    jd = JDataset(j_rmat(**kw), feature_dim=8, num_classes=4, seed=0)
    td = SyntheticGraphDataset(rmat_graph(**kw, device="cpu"), feature_dim=8, num_classes=4,
                               seed=0)
    return jd, td


def _cfg(mode, sampler, schedule):
    kappa, _ = SCHEDULES[schedule]
    return dict(mode=mode, num_pes=2, local_batch=8, num_layers=2, sampler=sampler,
                fanout=3, schedule=schedule, kappa=kappa, plan_backend="fused", seed=3)


def _leaves(plan):
    out = {"input_ids": plan.input_ids, "seed_ids": plan.seed_ids}
    for l, layer in enumerate(plan.layers):
        for name in ("seeds", "self_idx", "nbr_idx", "mask", "slot_to_tilde", "req_idx",
                     "tilde_ids"):
            if getattr(layer, name, None) is not None:
                out[f"{name}{l}"] = np.asarray(getattr(layer, name))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("sampler", ["labor0", "ns", "rw", "full"])
@pytest.mark.parametrize("mode", ["cooperative", "independent"])
def test_device_state_plan_at_equals_jax(graphs, mode, sampler, schedule):
    jd, td = graphs
    kw = _cfg(mode, sampler, schedule)
    je = JEngine.from_config(jd.graph, JEngineConfig(**kw), dataset=jd)
    te = MinibatchEngine.from_config(td.graph, EngineConfig(**kw), dataset=td, device="cpu")
    assert not te.captures
    for step in SCHEDULES[schedule][1]:
        plan, seeds = te.plan_and_seeds(step)
        np.testing.assert_array_equal(seeds.numpy(), je.seed_batch(step), err_msg=str(step))
        want, got = _leaves(je.plan_at(step)), _leaves(plan)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {step} {k}")
    assert te.plan_program.compiles == {8: 1}


def test_trace_pass_over_plan_at_has_no_sync_and_one_program(graphs):
    """c = 0 (step 0) and c > 0 (steps 1, 3) dispatch one op sequence with
    no host sync, by the analyzer's own recorder and its trace pass."""
    _, td = graphs
    eng = MinibatchEngine.from_config(
        td.graph, EngineConfig(**_cfg("cooperative", "labor0", "smoothed")), dataset=td,
        device="cpu")
    eng.plan_at(0)  # lazily built state first, as the pass does
    assert eng.rng_state(0).c == 0.0 and eng.rng_state(1).c > 0.0
    cpu = torch.device("cpu")
    records = [record_call(cpu, eng.plan_at, step)[1] for step in (0, 1, 3)]
    assert [r.syncs for r in records] == [0, 0, 0]
    assert records[0].signature() == records[1].signature() == records[2].signature()
    entry = TraceEntry("engine.plan_at[smoothed]", "src/repro_torch/engine/engine.py",
                       lambda device: (eng.plan_at, [lambda: ((0,), {}), lambda: ((1,), {})]))
    (finding,) = run_trace(cpu, [entry])
    assert finding.rule == "RA200" and finding.severity != Severity.ERROR
    assert finding.extra["same_signature"]


# --------------------------------------------------------------------------
# CompiledFunction, BucketGuard and the configurations that capture
# --------------------------------------------------------------------------
def test_compiled_function_signatures_and_compiles():
    calls = []
    f = CompiledFunction("double", lambda x: calls.append(x) or x * 2)
    a, b = torch.ones(4), torch.ones(8)
    assert torch.equal(f(4, a), a * 2) and torch.equal(f(8, b), b * 2)
    assert torch.equal(f(4, a + 1), (a + 1) * 2)  # same shape: the same program
    assert f.compiles == {4: 1, 8: 1} and len(calls) == 3
    assert f.program(4) is None  # eager: nothing captured
    with pytest.raises(RetraceError, match="bucket 4"):
        f(4, b)
    assert f.compiles == {4: 2, 8: 1} and len(calls) == 3  # raised before running
    with pytest.raises(RetraceError, match="retraced buckets"):
        f.assert_compiled_once_per_bucket()
    assert shape_signature((a, None, [b.int()])) == (((4,), torch.float32),
                                                     ((8,), torch.int32))


def test_capture_is_chosen_by_configuration_only(graphs):
    _, td = graphs
    fused = MinibatchEngine.from_config(
        td.graph, EngineConfig(**_cfg("cooperative", "labor0", "smoothed")), dataset=td,
        device="cpu")
    ref = MinibatchEngine.from_config(
        td.graph, EngineConfig(**{**_cfg("cooperative", "labor0", "smoothed"),
                                  "plan_backend": "reference"}), dataset=td, device="cpu")
    assert not fused.captures and not ref.captures  # the CPU
    # the same engines on a card (nothing runs): fused captures, reference not
    on_card = lambda e: dataclasses.replace(e, device=torch.device("cuda"))
    assert on_card(fused).captures and not on_card(ref).captures


def test_shard_capture_is_chosen_by_configuration_only(graphs, monkeypatch):
    """Under the shard executor a card captures with an NCCL group and not
    with gloo; the CPU never.  The step program records its spans either
    way (a traced step stays one graph).  Nothing runs: the group's size
    and backend are stand-ins."""
    import torch.distributed as dist

    from repro_torch.core.cooperative import ShardExecutor
    from repro_torch.train import step_program

    _, td = graphs
    sim = MinibatchEngine.from_config(
        td.graph, EngineConfig(**_cfg("cooperative", "labor0", "smoothed")), dataset=td,
        device="cpu")
    P = sim.config.num_pes
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: P)
    shard = lambda device: dataclasses.replace(  # noqa: E731
        sim, device=torch.device(device), ex=ShardExecutor(P))
    for backend in ("gloo", "nccl"):
        monkeypatch.setattr(dist, "get_backend", lambda group=None, b=backend: b)
        card = shard("cuda")
        assert card.captures == card.shard_runner.captures == (backend == "nccl")
        assert card.shard_runner.plan_program.capture == (backend == "nccl")
        model = torch.nn.Linear(1, 1)
        prog = step_program(card, None, model, None, None, 1e-3)
        assert prog.capture == (backend == "nccl") and not prog.compiles
        assert prog.records_spans and card.shard_runner.plan_program.records_spans
        assert not shard("cpu").captures


def test_stream_seeds_resolve_lazily(graphs):
    _, td = graphs
    eng = MinibatchEngine.from_config(
        td.graph, EngineConfig(**_cfg("cooperative", "ns", "nested")), dataset=td,
        device="cpu")
    items = list(eng.stream(6, prefetch=2))
    for item in items:
        assert isinstance(item.seed_rows, HostRows)
        np.testing.assert_array_equal(item.seeds, eng.seed_batch(item.step))
    rows = HostRows(torch.arange(6, dtype=torch.int32).reshape(2, 3))
    np.testing.assert_array_equal(rows.numpy(), np.arange(6).reshape(2, 3))


# --------------------------------------------------------------------------
# the GNN train step as one program
# --------------------------------------------------------------------------
def test_device_step_adam_bit_equal_to_jax_over_20_steps():
    """The step on the device and the bias corrections from the powf table:
    parameters, moments and step bit for bit with the JAX package's
    ``adam_update`` over 20 steps of gradients from 1e-9 to 10 (numpy's
    power, the scales before, differed at step 4 and at step 9)."""
    from repro.train import optim as joptim
    from repro_torch.train.optim import adam_init, adam_update

    rng = np.random.default_rng(7)
    shapes = [(5, 3), (3,), (2, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp, jst = [jnp.asarray(p) for p in params], joptim.adam_init([jnp.asarray(p)
                                                                 for p in params])
    tp = [torch.from_numpy(p.copy()) for p in params]
    st = adam_init(tp)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    # op by op: under jit XLA fuses the update into FMAs, which torch's
    # elementwise ops do not round as
    j_update = lambda p, g, s: joptim.adam_update(p, g, s, lr=1e-2)
    for _ in range(20):
        grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 2)).astype(np.float32)
                 for s in shapes]
        jp, jst = j_update(jp, [jnp.asarray(g) for g in grads], jst)
        assert adam_update(tp, [torch.from_numpy(g) for g in grads], st, lr=1e-2) is st
        for got, want in zip(tp + st.mu + st.nu, list(jp) + list(jst.mu) + list(jst.nu)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(st.step) == int(jst.step) == 20


def test_train_step_program_equals_jax_train_gnn(graphs):
    from repro.models.gnn import GNNConfig as JGNNConfig
    from repro.train import loop as jloop
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.train import TrainConfig, adam_init, step_program, train_gnn

    jd, td = graphs
    tc = dict(num_pes=2, local_batch=8, fanout=3, num_steps=4, schedule="smoothed", kappa=4,
              eval_every=0, plan_backend="fused", lr=1e-2)
    gcfg = dict(model="gcn", num_layers=2, in_dim=8, hidden_dim=16, num_classes=4)
    want = jloop.train_gnn(jd, JGNNConfig(**gcfg), jloop.TrainConfig(**tc))
    got = train_gnn(td, GNNConfig(**gcfg), TrainConfig(**tc), device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert not got.stage_ms and len(got.step_ms) == 4
    for layer, jl in zip(got.params["layers"], want.params["layers"]):
        for name in jl:
            np.testing.assert_allclose(layer[name], np.asarray(jl[name]), rtol=0, atol=1e-5)

    # the program itself: one signature a key, the step read from the buffer
    eng = MinibatchEngine.from_config(td.graph, TrainConfig(**tc).engine_config(2),
                                      dataset=td, device="cpu")
    model = init_gnn(GNNConfig(**gcfg), seed=0, device="cpu")
    opt = adam_init(model)
    prog = step_program(eng, GNNConfig(**gcfg), model, opt, torch.as_tensor(td.labels), 1e-2,
                        with_plan=True)
    assert not prog.capture  # the CPU
    losses = []
    for step in range(4):
        loss, plan = prog(8, eng.step_state(step))
        losses.append(float(loss))
        np.testing.assert_array_equal(plan.input_ids.numpy(), eng.plan_at(step).input_ids.numpy())
    np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
    assert prog.compiles == {8: 1} and int(opt.step) == 4
    bad = trng.DeviceRNGState(eng.step_state(4).buf[:5])
    with pytest.raises(RetraceError, match="train_step: bucket 8"):
        prog(8, bad)


def test_tiered_store_programs_retrace_on_a_second_signature():
    from repro_torch.store import TieredFeatureStore

    feats = np.random.default_rng(1).standard_normal((64, 4)).astype(np.float32)
    store = TieredFeatureStore(feats, capacity=16, ways=4, device="cpu")
    store.gather(torch.arange(8, dtype=torch.int32), key="b8")
    store.gather(torch.arange(4, 12, dtype=torch.int32), key="b8")  # same shape: same program
    assert store.access_program.compiles == store.assemble_program.compiles == {"b8": 1}
    with pytest.raises(RetraceError, match="store.clock_access: bucket b8"):
        store.gather(torch.arange(9, dtype=torch.int32), key="b8")


# --------------------------------------------------------------------------
# the LM decode program
# --------------------------------------------------------------------------
def test_lm_decode_program_equals_jax_prefill_and_greedy_tokens():
    from repro.configs import get_config as j_get_config
    from repro.launch.steps import make_serve_step as j_make_serve_step
    from repro.models.transformer import init_decode_state as j_init_decode_state
    from repro.models.transformer import init_lm as j_init_lm
    from repro.models.transformer import prefill_decode as j_prefill_decode
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import (
        decode_program,
        init_decode_state,
        lm_params_from_jax,
        prefill_decode,
    )

    B, S0, new = 2, 10, 6
    jcfg = j_get_config("hymba-1.5b").reduced(ssm_chunk=8, window=8)  # ring caches wrap
    cfg = get_config("hymba-1.5b").reduced(ssm_chunk=8, window=8)
    params = j_init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)

    j_serve = jax.jit(j_make_serve_step(jcfg))
    jl, jst = jax.jit(lambda p, st, t: j_prefill_decode(p, jcfg, st, t))(
        params, j_init_decode_state(jcfg, B, S0 + new), jnp.asarray(prompts))
    state = init_decode_state(cfg, B, S0 + new, device="cpu")
    logits, out = prefill_decode(model, cfg, state, torch.from_numpy(prompts))
    assert out is state  # written in place
    assert int(state["pos"]) == S0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    serve, want, got = make_serve_step(cfg), [], []
    jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(new):
        want.append(np.asarray(jtok)[:, 0])
        got.append(tok[:, 0].numpy())
        jl, jst = j_serve(params, jst, jtok)
        logits, state = serve(model, state, tok)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    prog = decode_program(model, cfg)
    assert prog.compiles == {(B, S0 + new): 1} and not prog.capture

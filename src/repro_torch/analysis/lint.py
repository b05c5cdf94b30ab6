"""AST lint framework with pluggable repo-specific rules (port of
``repro.analysis.lint``).

The framework owns the mechanics -- file discovery, parsing, import-alias
resolution, hot-path scope computation, inline-suppression filtering --
so each rule (see :mod:`repro_torch.analysis.rules`) is a small visitor
over a pre-digested :class:`FileContext`.

Hot-path scopes
---------------
The JAX package's hot scopes are its ``jax.jit`` functions.  The port has
no jit, and its hot code carries no decorator, so its hot scopes are
named in one table, :data:`HOT_SCOPES`: by file (relative to the
``repro_torch`` package) and qualified name, the port's counterparts of
the functions the JAX package runs under ``jax.jit`` -- the jitted
functions themselves (the plan build, the samplers, the frontier
algebra, the RNG, the kernel wrappers and their plain versions, the
CLOCK access, the train step, the serving step) and what they call
every step.  As in the reference:

* every function nested within a hot function is hot;
* methods of classes named in :data:`HOT_CLASSES` are hot (the
  streaming pipeline: a host sync inside ``MinibatchStream`` serializes
  exactly the prefetch it exists to provide), and so is what the stream
  calls every step (``MinibatchEngine.seed_batch``).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

from repro_torch.analysis.findings import Finding, Severity, is_suppressed

#: Classes whose methods count as hot paths.
HOT_CLASSES = frozenset({"MinibatchStream"})

_KERNEL_WRAPPERS = {
    "kernels/gather/ops.py": ("gather", "gather_cuda"),
    "kernels/gather/ref.py": ("gather_ref",),
    "kernels/spmm/ops.py": (
        "spmm_sum", "spmm_mean", "spmm_cuda", "spmm_backward_cuda",
        "_Spmm.forward", "_Spmm.backward",
    ),
    "kernels/spmm/ref.py": ("spmm_ref", "spmm_backward_ref"),
    "kernels/seg_softmax/ops.py": (
        "seg_softmax", "seg_softmax_cuda", "seg_softmax_backward_cuda",
        "_SegSoftmax.forward", "_SegSoftmax.backward",
    ),
    "kernels/seg_softmax/ref.py": ("seg_softmax_ref", "seg_softmax_backward_ref"),
    "kernels/frontier_gather/ops.py": ("frontier_gather", "frontier_gather_cuda"),
    "kernels/frontier_gather/ref.py": ("frontier_gather_ref",),
    "kernels/unique_compact/ops.py": (
        "unique_with_inverse", "unique_compact", "unique_compact_cuda",
    ),
    "kernels/unique_compact/ref.py": (
        "unique_with_inverse_ref", "unique_compact_sorted_ref",
    ),
    "kernels/expand_indptr/ops.py": ("expand_indptr", "expand_indptr_cuda"),
    "kernels/expand_indptr/ref.py": ("expand_indptr_ref",),
    "store/kernel.py": ("tag_probe", "tag_probe_cuda", "probe_ref"),
    "kernels/exchange/ops.py": (
        "exchange_tables", "exchange_tables_cuda", "exchange_rows", "exchange_forward_cuda",
        "exchange_backward_cuda", "_rows_cuda", "_ExchangeRows.forward",
        "_ExchangeRows.backward",
    ),
    "kernels/exchange/ref.py": (
        "exchange_tables_ref", "exchange_forward_ref", "exchange_backward_ref",
    ),
}

#: ``{file under repro_torch/: qualified names}`` of the hot functions.
HOT_SCOPES = {
    **_KERNEL_WRAPPERS,
    "core/frontier.py": (
        "pad_to", "unique_padded", "union_padded", "lookup", "contains",
        "count_valid", "multiplicity", "compact", "unique_with_inverse",
        "unique_compact", "take_rows",
    ),
    "core/graph.py": (
        "Graph.neighbor_table", "Graph.neighbor_edge_types", "_neighbor_table",
    ),
    "core/rng.py": (
        "hash_u32", "hash_pair_u32", "uniform_from_u32", "uniform_from_ids",
        "normal_from_ids", "normal_from_pairs", "ndtr", "ndtri", "_smoothed",
        "RNGState.vertex_uniform", "RNGState.edge_uniform",
        "DeviceRNGState.vertex_uniform", "DeviceRNGState.edge_uniform",
        "DeviceRNGState.fold",
        "DependentRNG.vertex_uniform", "DependentRNG.edge_uniform",
    ),
    "core/samplers/labor.py": ("LaborSampler.sample_layer", "_row_sum", "_solve_cs"),
    "core/samplers/neighbor.py": ("NeighborSampler.sample_layer", "bottom_k"),
    "core/samplers/random_walk.py": (
        "RandomWalkSampler.sample_layer", "walk", "top_visited",
    ),
    "core/samplers/full.py": ("FullSampler.sample_layer",),
    "core/minibatch.py": ("build_minibatch", "Minibatch.gather_inputs"),
    "core/cooperative.py": (
        "SimExecutor.pe", "SimExecutor.exchange", "SimExecutor.redistribute",
        "SimExecutor.moved_rows", "ShardExecutor.pe", "ShardExecutor.exchange",
        "ShardExecutor.redistribute", "ShardExecutor.moved_rows",
        "_bucketize", "build_cooperative_minibatch",
        "redistribute", "CoopMinibatch.gather_inputs",
    ),
    "core/feature_loader.py": ("FeatureStore.gather",),
    "engine/engine.py": (
        "_hash_permute_rows", "MinibatchEngine._seed_batch",
        "MinibatchEngine.seed_batch", "MinibatchEngine.build_plan",
        "MinibatchEngine.plan_at", "MinibatchEngine.gather_features",
        "MinibatchEngine.apply_model",
    ),
    "engine/shard.py": ("ShardRunner.plan_at", "ShardRunner._build_at",
                        "ShardRunner.loss_and_grad", "ShardRunner.plan_loss_and_grad"),
    "models/gnn/layers.py": (
        "GCNLayer.forward", "SAGELayer.forward", "RGCNLayer.forward",
        "GATLayer.forward", "GNN.forward", "gnn_apply", "gnn_apply_stacked",
        "gnn_apply_cooperative",
    ),
    "train/loop.py": ("plan_loss", "step_loss", "plan_grads", "step_program"),
    "train/metrics.py": ("masked_softmax_xent",),
    "train/optim.py": ("adam_update",),
    "store/clock.py": ("hash_set", "unique_rows", "_insert", "clock_access"),
    # the two programs' bodies; the host fill between them (the missed
    # ids' read) is the gather's one sync, counted by the trace pass
    "store/tiers.py": ("_assemble", "TieredFeatureStore._access",
                       "TieredFeatureStore._fill_assemble"),
    "serve/coalesce.py": ("Coalescer.build_plan",),
    "serve/server.py": ("GNNServer.hot_path",),
}


def hot_names(path: str) -> frozenset:
    """Qualified names :data:`HOT_SCOPES` lists for the port file ``path``."""
    norm = os.path.abspath(path).replace(os.sep, "/")
    for rel, names in HOT_SCOPES.items():
        if norm.endswith("/repro_torch/" + rel):
            return frozenset(names)
    return frozenset()


# --- import alias resolution ----------------------------------------------

@dataclass
class ImportMap:
    """Maps local names to fully-qualified module paths.

    ``import numpy as np``                       -> {"np": "numpy"}
    ``from repro_torch.core import threefry``    -> {"threefry": "repro_torch.core.threefry"}
    ``from repro_torch.kernels import _build``   -> {"_build": "repro_torch.kernels._build"}
    """

    names: dict = field(default_factory=dict)

    def collect(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.names[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def qualify(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression like ``np.asarray`` /
        ``torch.cuda.synchronize``, with the leading alias expanded; None
        for non-name expressions."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.names.get(node.id, node.id))
        return ".".join(reversed(parts))


# --- per-file context ------------------------------------------------------

@dataclass
class FileContext:
    path: str
    source: str
    source_lines: list
    tree: ast.AST
    imports: ImportMap
    #: FunctionDef/AsyncFunctionDef nodes considered hot (table or stream).
    hot_functions: set = field(default_factory=set)
    #: all function nodes, in source order
    functions: list = field(default_factory=list)
    #: maps each node id() to its enclosing function node (or None)
    enclosing: dict = field(default_factory=dict)

    def is_hot(self, node: ast.AST) -> bool:
        """True when ``node`` sits inside a hot function scope."""
        fn = self.enclosing.get(id(node))
        while fn is not None:
            if fn in self.hot_functions:
                return True
            fn = self.enclosing.get(id(fn))
        return False

    def qualify(self, node: ast.AST) -> Optional[str]:
        return self.imports.qualify(node)


_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def build_context(path: str, source: str) -> FileContext:
    tree = ast.parse(source, filename=path)
    imports = ImportMap()
    imports.collect(tree)
    ctx = FileContext(
        path=path,
        source=source,
        source_lines=source.splitlines(),
        tree=tree,
        imports=imports,
    )
    hot = hot_names(path)

    def visit(node: ast.AST, fn: Optional[ast.AST], cls: Optional[ast.AST],
              prefix: str):
        for child in ast.iter_child_nodes(node):
            child_fn, child_cls, child_prefix = fn, cls, prefix
            if isinstance(child, _FUNCTION_NODES):
                ctx.functions.append(child)
                ctx.enclosing[id(child)] = fn
                qualname = prefix + child.name
                if qualname in hot or fn in ctx.hot_functions or (
                    cls is not None and cls.name in HOT_CLASSES and fn is None
                ):
                    ctx.hot_functions.add(child)
                child_fn, child_cls = child, None
                child_prefix = qualname + "."
            elif isinstance(child, ast.ClassDef):
                ctx.enclosing[id(child)] = fn
                child_cls = child
                child_prefix = prefix + child.name + "."
            else:
                ctx.enclosing[id(child)] = fn
            visit(child, child_fn, child_cls, child_prefix)

    visit(tree, None, None, "")
    return ctx


# --- rule base -------------------------------------------------------------

class LintRule:
    """Base class: subclass, set ``rule_id``/``severity``, implement check."""

    rule_id: str = "RA000"
    severity: Severity = Severity.ERROR
    title: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self, ctx: FileContext, node: ast.AST, message: str, **extra
    ) -> Finding:
        return Finding(
            rule=self.rule_id,
            severity=self.severity,
            message=message,
            file=ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            extra=extra,
        )


# --- runner ----------------------------------------------------------------

def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if not d.startswith(".") and d != "__pycache__"
            )
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def run_lint(
    paths: Iterable[str], rules: Optional[list] = None
) -> tuple:
    """Run lint rules over ``paths``; returns (findings, files_scanned)."""
    if rules is None:
        from repro_torch.analysis.rules import default_rules

        rules = default_rules()
    findings = []
    n_files = 0
    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            ctx = build_context(path, source)
        except (OSError, SyntaxError) as e:
            findings.append(
                Finding(
                    rule="RA999",
                    severity=Severity.ERROR,
                    message=f"could not parse file: {e}",
                    file=path,
                    line=getattr(e, "lineno", 0) or 0,
                )
            )
            continue
        n_files += 1
        for rule in rules:
            for f in rule.check(ctx):
                if not is_suppressed(f, ctx.source_lines):
                    findings.append(f)
    return findings, n_files

"""Repo-specific lint rules (RA0xx), read for PyTorch (port of
``repro.analysis.rules``).

Rule catalog
------------
RA001 host-sync-in-stream   ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                            ``.numpy()`` / ``torch.cuda.synchronize`` /
                            ``bool()``, ``int()`` or ``float()`` of a
                            call that returns a tensor, inside a hot path.
RA002 numpy-in-hot-path     host ``numpy`` call inside a hot path.
RA003 rng-key-reuse         a ``repro_torch.core.threefry`` key consumed
                            twice without being split/reassigned in between.
RA004 traced-python-branch  Python ``if``/``while`` on a tensor expression
                            inside a hot path.
RA005 bare-assert-kernel    ``assert`` precondition in a kernel module --
                            use KernelContractError instead.

The ids, titles and severities are the reference's, so findings can be
suppressed inline (``# ra: ignore[RA003]``) and counted across runs by
the same consumer.  Hot paths are the scopes of
:mod:`repro_torch.analysis.lint`.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.lint import FileContext, LintRule

_THREEFRY = "repro_torch.core.threefry."

#: threefry functions that CONSUME the key passed to them -- after one of
#: these, reusing the same key correlates what must be independent.
_KEY_CONSUMERS = frozenset({"split", "random_bits", "uniform"})

#: functions whose result *is* a fresh key (assignment targets become keys)
_KEY_PRODUCERS = frozenset({"prng_key", "split"})

#: tensor methods that copy to the host or wait for the device
_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_SCALAR_CASTS = frozenset({"bool", "int", "float"})

#: tensor methods that return a tensor (a reduction or predicate a host
#: cast or a Python branch would have to wait for)
_TENSOR_METHODS = frozenset({
    "any", "all", "sum", "max", "min", "amax", "amin", "argmax", "argmin",
    "mean", "prod", "count_nonzero", "eq", "ne", "lt", "le", "gt", "ge",
    "equal", "isnan", "isinf", "isfinite", "nonzero", "norm",
})

#: ``torch.*`` calls that return host values, not tensors
_TORCH_HOST_CALLS = frozenset({
    "torch.is_tensor", "torch.is_grad_enabled", "torch.is_floating_point",
    "torch.cuda.is_available", "torch.cuda.device_count", "torch.device",
    "torch.get_default_dtype", "torch.are_deterministic_algorithms_enabled",
})


def _tensor_call(ctx: FileContext, node: ast.AST) -> Optional[str]:
    """The name of ``node`` when it is a call that returns a tensor: a
    ``torch.*`` call or a tensor method from :data:`_TENSOR_METHODS`."""
    if not isinstance(node, ast.Call):
        return None
    q = ctx.qualify(node.func)
    if q and q.startswith("torch.") and q not in _TORCH_HOST_CALLS:
        return q
    if isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_METHODS:
        return f".{node.func.attr}()"
    return None


class HostSyncInHotPath(LintRule):
    rule_id = "RA001"
    severity = Severity.ERROR
    title = "host-sync-in-stream"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.is_hot(node):
                continue
            q = ctx.qualify(node.func)
            if q in _HOST_SYNC_CALLS:
                yield self.finding(
                    ctx, node,
                    f"`{q}` waits for the device inside a hot path; it stalls "
                    "the stream/step pipeline -- hoist it out of the hot path "
                    "or drop it",
                    call=q,
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_SYNC_ATTRS
                and not node.args
            ):
                yield self.finding(
                    ctx, node,
                    f"`.{node.func.attr}()` copies to the host and waits for "
                    "the device inside a hot path; keep values on the device "
                    "(or sync once per logging interval outside the hot loop)",
                    call=f".{node.func.attr}()",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in _SCALAR_CASTS
                and len(node.args) == 1
            ):
                inner = _tensor_call(ctx, node.args[0])
                if inner:
                    yield self.finding(
                        ctx, node,
                        f"`{node.func.id}()` of tensor `{inner}` reads a "
                        "device scalar on the host inside a hot path "
                        "(aten._local_scalar_dense): the host waits for "
                        "every queued kernel",
                        call=f"{node.func.id}({inner})",
                    )


class NumpyInHotPath(LintRule):
    rule_id = "RA002"
    severity = Severity.ERROR
    title = "numpy-in-hot-path"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.is_hot(node):
                continue
            q = ctx.qualify(node.func)
            if q and (q == "numpy" or q.startswith("numpy.")):
                yield self.finding(
                    ctx, node,
                    f"host `{q}` call inside a hot path: its inputs and "
                    "outputs live on the host, so device data must be copied "
                    "back for it; use the torch equivalent on the device",
                    call=q,
                )


class RngKeyReuse(LintRule):
    rule_id = "RA003"
    severity = Severity.ERROR
    title = "rng-key-reuse"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ctx.functions:
            yield from self._check_fn(ctx, fn)

    # -- helpers -----------------------------------------------------------

    def _is_random_call(self, ctx: FileContext, call: ast.Call) -> Optional[str]:
        """Returns the threefry function name, or None."""
        q = ctx.qualify(call.func)
        if q and q.startswith(_THREEFRY):
            return q[len(_THREEFRY):]
        return None

    def _check_fn(self, ctx: FileContext, fn) -> Iterator[Finding]:
        # Ordered statement scan over this function's own body (nested
        # defs are analyzed separately).  Straight-line approximation:
        # exclusive if/else arms are treated as sequential, which only
        # over-reports for code consuming the same key on both arms --
        # rare, and suppressible inline.
        keys: dict = {}        # name -> "live" | "consumed"
        consumed_sub: set = set()  # (name, const_index) sub-keys consumed
        findings = []

        def key_token(expr):
            """Bare `k` -> "k"; `ks[0]` -> ("ks", 0); else None."""
            if isinstance(expr, ast.Name):
                return expr.id
            if (
                isinstance(expr, ast.Subscript)
                and isinstance(expr.value, ast.Name)
                and isinstance(expr.slice, ast.Constant)
            ):
                return (expr.value.id, expr.slice.value)
            return None

        def handle_call(call: ast.Call):
            name = self._is_random_call(ctx, call)
            if name is None or name not in _KEY_CONSUMERS:
                return
            exprs = list(call.args) + [kw.value for kw in call.keywords]
            for expr in exprs:
                tok = key_token(expr)
                if tok is None:
                    continue
                if isinstance(tok, tuple):  # sub-key like ks[0]
                    if tok[0] not in keys:
                        continue
                    if tok in consumed_sub or keys.get(tok[0]) == "consumed":
                        findings.append(self.finding(
                            ctx, call,
                            f"PRNG sub-key `{tok[0]}[{tok[1]}]` is reused "
                            "after being consumed; split again for a "
                            "fresh key",
                            key=f"{tok[0]}[{tok[1]}]", consumer=name,
                        ))
                    else:
                        consumed_sub.add(tok)
                else:
                    if keys.get(tok) == "consumed":
                        findings.append(self.finding(
                            ctx, call,
                            f"PRNG key `{tok}` is reused after being "
                            "consumed; split it first (every threefry "
                            "consumption must see a fresh key)",
                            key=tok, consumer=name,
                        ))
                    elif tok in keys:
                        keys[tok] = "consumed"

        def mark_targets(target, producing: bool):
            if isinstance(target, ast.Name):
                if producing:
                    keys[target.id] = "live"
                    consumed_sub.difference_update(
                        t for t in list(consumed_sub) if t[0] == target.id
                    )
                else:
                    keys.pop(target.id, None)
            elif isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    inner = elt.value if isinstance(elt, ast.Starred) else elt
                    mark_targets(inner, producing)

        def calls_in(expr):
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call):
                    yield sub

        def process_block(stmts):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue  # separate scope
                if isinstance(stmt, ast.Assign):
                    for c in calls_in(stmt.value):
                        handle_call(c)
                    producing = (
                        isinstance(stmt.value, ast.Call)
                        and (self._is_random_call(ctx, stmt.value) or "")
                        in _KEY_PRODUCERS
                    )
                    for tgt in stmt.targets:
                        mark_targets(tgt, producing)
                    continue
                if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    if stmt.value is not None:
                        for c in calls_in(stmt.value):
                            handle_call(c)
                    mark_targets(stmt.target, False)
                    continue
                # generic statement: consume calls in its expressions,
                # then recurse into nested blocks in source order
                for field_name in ("test", "iter", "value", "exc", "items"):
                    sub = getattr(stmt, field_name, None)
                    if sub is None:
                        continue
                    for expr in sub if isinstance(sub, list) else [sub]:
                        node = getattr(expr, "context_expr", expr)
                        for c in calls_in(node):
                            handle_call(c)
                for block_name in ("body", "orelse", "finalbody"):
                    block = getattr(stmt, block_name, None)
                    if isinstance(block, list):
                        process_block(
                            [s for s in block if isinstance(s, ast.stmt)]
                        )
                for handler in getattr(stmt, "handlers", []) or []:
                    process_block(handler.body)

        process_block(fn.body)
        yield from findings


class TracedPythonBranch(LintRule):
    rule_id = "RA004"
    severity = Severity.ERROR
    title = "traced-python-branch"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.If, ast.While)) or not ctx.is_hot(node):
                continue
            culprit = self._tensor_expr(ctx, node.test)
            if culprit:
                kind = "if" if isinstance(node, ast.If) else "while"
                yield self.finding(
                    ctx, node,
                    f"Python `{kind}` on tensor expression `{culprit}` "
                    "inside a hot path: the host waits for the device to "
                    "decide the branch, and the op sequence then depends on "
                    "the data (no CUDA graph can hold it); use torch.where "
                    "or a fixed shape",
                    expr=culprit,
                )

    def _tensor_expr(self, ctx: FileContext, test: ast.AST) -> Optional[str]:
        for sub in ast.walk(test):
            culprit = _tensor_call(ctx, sub)
            if culprit:
                return culprit
        return None


class BareAssertInKernel(LintRule):
    rule_id = "RA005"
    severity = Severity.ERROR
    title = "bare-assert-kernel"

    def _is_kernel_module(self, ctx: FileContext) -> bool:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                q = ctx.qualify(node.func)
                if q and q.endswith("kernels._build.launch"):
                    return True
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not self._is_kernel_module(ctx):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield self.finding(
                    ctx, node,
                    "bare `assert` as a kernel precondition: asserts "
                    "vanish under `python -O` and carry no shapes; raise "
                    "KernelContractError (repro_torch.kernels.errors) with "
                    "the offending values instead",
                )


def default_rules() -> list:
    return [
        HostSyncInHotPath(),
        NumpyInHotPath(),
        RngKeyReuse(),
        TracedPythonBranch(),
        BareAssertInKernel(),
    ]

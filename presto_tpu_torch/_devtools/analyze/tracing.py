"""Device-sync bracketing: every deliberate host wait on the device is a
span.

The counterpart of the JAX package's ``tools/analyze/tracing.py``, which
holds five rules over jitted code. One of them has an eager-PyTorch
counterpart, and it is the rule here:

- ``unbracketed-sync`` — a host read of device data (``.item()``,
  ``.tolist()``, ``.cpu()``) or ``torch.cuda.synchronize()`` outside a
  ``TRACER.span("device-sync", ...)`` (or ``"jit-compile"``) scope, the
  mesh executor's ``_sync_record(...)`` (which opens that span and feeds
  the flight recorder's control_sync bucket) or a profiler context.
  Kernels are launched asynchronously, so an unbracketed sync is a stall
  nobody sees in the trace viewer: every deliberate device round trip
  must be a span.

The JAX rules with no counterpart in eager PyTorch are left out: host
branches on traced values (nothing is traced: a host branch on a tensor
is an ordinary sync, which the rule above sees), raw ``jax.jit`` that
bypasses ``ops/jitcache`` (the port compiles no programs; its hand
kernels are counted by ``obs/profiler.KERNELS``), and trace-time
nondeterminism (no trace freezes a value into an executable).

The AST cannot tell a tensor from a numpy array or a list, so a
``.tolist()`` of a host array matches too; the baseline holds the
reviewed host-side sites with their reasons.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .base import (Finding, add_parents, ancestors, dotted,
                   enclosing_symbol, parse_file, rel, str_const, walk_py)

CHECKER = "tracing"

#: the modules of the JAX rule's scope: the operators, the exchange,
#: the fused chains and the executors
SCOPE = ("presto_tpu_torch/ops", "presto_tpu_torch/parallel",
         "presto_tpu_torch/exec/fused.py",
         "presto_tpu_torch/exec/distributed.py",
         "presto_tpu_torch/exec/local.py",
         "presto_tpu_torch/exec/local_exchange.py")

#: tensor methods that wait for the device and copy to the host
_SYNC_METHODS = ("item", "tolist", "cpu")
#: calls that wait for the device
_SYNC_CALLS = ("torch.cuda.synchronize",)


def _inside_sync_span(node: ast.AST) -> bool:
    """Lexically under ``with TRACER.span("device-sync"|"jit-compile",
    ...)``, under ``_sync_record(...)``, or under any ``with`` whose
    context manager comes from the profiler."""
    for anc in ancestors(node):
        if not isinstance(anc, ast.With):
            continue
        for item in anc.items:
            ctx = item.context_expr
            if not isinstance(ctx, ast.Call):
                continue
            name = dotted(ctx.func) or ""
            if name.split(".")[-1] == "_sync_record":
                return True
            if name.endswith(".span") and ctx.args:
                s = str_const(ctx.args[0])
                if s and (s.startswith("device-sync")
                          or s.startswith("jit-compile")):
                    return True
            if "_prof" in name or "profiler" in name:
                return True
    return False


def _sync_kind(node: ast.Call):
    """The sync a call makes (``item`` / ``tolist`` / ``cpu`` /
    ``torch.cuda.synchronize``), or None."""
    name = dotted(node.func) or ""
    if name in _SYNC_CALLS:
        return name
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS and not node.args \
            and not node.keywords:
        return node.func.attr
    return None


def _file_findings(path: str, rpath: str) -> List[Finding]:
    tree = parse_file(path)
    if tree is None:
        return [Finding(CHECKER, "parse-error", rpath, 1, "<module>",
                        "file does not parse")]
    add_parents(tree)
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _sync_kind(node)
        if what is None or _inside_sync_span(node):
            continue
        sym = enclosing_symbol(node)
        out.append(Finding(
            CHECKER, "unbracketed-sync", rpath, node.lineno,
            f"{sym}.{what}",
            f"{what} outside a TRACER.span(\"device-sync\") scope — "
            f"deliberate device round trips must be observable stalls"))
    return out


def check_paths(paths: Sequence[str], root: str) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        out.extend(_file_findings(p, rel(p, root)))
    return out


def check(root: str, scope: Sequence[str] = SCOPE) -> List[Finding]:
    return check_paths(sorted(set(walk_py(root, scope))), root)

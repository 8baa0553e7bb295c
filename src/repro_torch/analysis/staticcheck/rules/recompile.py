"""capture-hazard: graphs captured once, compiled callables traced once.

Port of the reference's ``recompile-hazard`` to PyTorch.  Launch
overhead is the paper's bottleneck term, and the port removes it by
capturing the decode step as one CUDA graph and replaying it; a capture
(or a ``torch.compile`` trace) that is rebuilt on every call pays for a
whole capture each time and replays nothing.  Two shapes reintroduce it:

  * a graph or a compiled callable built inside a loop / comprehension /
    immediately-invoked expression — ``torch.cuda.CUDAGraph()``,
    ``torch.cuda.graph(...)``, ``capture(...)`` (``core/dispatch.py``),
    ``StepProgram.executor(...)`` (its graph arms capture at their first
    call) or ``torch.compile(...)``: every construction captures or
    traces from scratch;
  * a ``torch.compile``d callable fed Python scalar or tuple literals —
    dynamo guards on each Python scalar's value (and marks it dynamic
    only after a recompile), so every distinct value traces again.

Only compiled callables bound in the same file are checked for the
literal-argument hazard.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.staticcheck.core import (FileContext, Finding,
                                                   dotted, register)

RULE = "capture-hazard"

_LOOPY = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_CAPTURES = {"torch.cuda.CUDAGraph", "CUDAGraph", "torch.cuda.graph",
             "capture", "dispatch.capture"}
_COMPILES = {"torch.compile", "compile"}


def _what_it_builds(node: ast.Call) -> Optional[str]:
    """What ``node`` builds (its callee text), if it builds a graph or a
    compiled callable."""
    d = dotted(node.func)
    if d in _CAPTURES or d == "torch.compile":
        return d
    if isinstance(node.func, ast.Attribute) and node.func.attr == "executor":
        return d or ".executor"
    # functools.partial(torch.compile, ...) used as a deferred factory
    if d in ("functools.partial", "partial") and node.args and \
            dotted(node.args[0]) in _COMPILES:
        return "torch.compile"
    return None


def _scalar_literal(node: ast.AST) -> Optional[str]:
    """Describe a retrace-prone literal argument, else None."""
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, bool)) and node.value is not None:
        return f"scalar literal {node.value!r}"
    if isinstance(node, ast.Tuple) and node.elts and all(
            isinstance(e, ast.Constant) for e in node.elts):
        return "tuple literal"
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.operand, ast.Constant):
        return "scalar literal"
    return None


@register(RULE, "graphs are captured once and compiled callables see no "
                "Python scalar literals")
def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node

    def enclosing_context(node: ast.AST) -> str:
        cur = parents.get(id(node))
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return ctx.qualname_of(cur)
            cur = parents.get(id(cur))
        return "<module>"

    compiled: set = set()

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _what_it_builds(node)
        if what is None:
            continue
        qual = enclosing_context(node)

        # (a) built inside a loop or comprehension
        cur = parents.get(id(node))
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            if isinstance(cur, _LOOPY):
                findings.append(ctx.finding(
                    RULE, node,
                    f"`{what}(...)` built inside a loop/comprehension — a "
                    f"fresh capture or trace every iteration (hoist it "
                    f"out; a graph only pays off when it is replayed)",
                    qual))
                break
            cur = parents.get(id(cur))

        # (b) immediately invoked: torch.compile(f)(x) — rebuilt per call
        parent = parents.get(id(node))
        if isinstance(parent, ast.Call) and parent.func is node:
            findings.append(ctx.finding(
                RULE, node,
                f"`{what}(...)` immediately invoked — the capture or trace "
                f"is rebuilt on every call (bind it once)", qual))

        # record same-file compiled bindings for the literal pass
        if what == "torch.compile" and isinstance(parent, ast.Assign) and \
                len(parent.targets) == 1:
            tgt = parent.targets[0]
            if isinstance(tgt, ast.Name):
                compiled.add(tgt.id)
            elif isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "self":
                compiled.add(f"self.{tgt.attr}")

    # (c) literal scalars/tuples at call sites of compiled bindings
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d is None or d not in compiled:
            continue
        qual = enclosing_context(node)
        for i, arg in enumerate(node.args):
            desc = _scalar_literal(arg)
            if desc is not None:
                findings.append(ctx.finding(
                    RULE, arg,
                    f"{desc} at position {i} of compiled `{d}` — dynamo "
                    f"guards on the value, so each distinct one traces "
                    f"again (pass a tensor)", qual))
        for kw in node.keywords:
            desc = None if kw.arg is None else _scalar_literal(kw.value)
            if desc is not None:
                findings.append(ctx.finding(
                    RULE, kw.value,
                    f"{desc} for keyword `{kw.arg}` of compiled `{d}` — "
                    f"dynamo guards on the value, so each distinct one "
                    f"traces again (pass a tensor)", qual))
    return findings

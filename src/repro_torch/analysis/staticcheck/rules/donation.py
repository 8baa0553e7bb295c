"""graph-output-alias: a graph's outputs are dead after its next replay.

Port of the reference's ``donation-safety`` to CUDA graphs.  A replay
writes its outputs in place, into the static tensors its capture
allocated: ``core/dispatch.py``'s executors return ``dict(self._out,
...)``, the scheduler's programs return ``prog.output``, and a
``_Captured``'s ``.output`` is rewritten by each ``.replay()``.  A value
taken from one replay and read after the next one silently reads the
newer step's numbers — the counterpart of reading a donated buffer.

Sources of graph outputs:

  * calls of replaying callables: same-file bindings ``X =
    <program>.executor(...)`` / ``X = _GraphExecutor(...)``, and
    ``KNOWN_REPLAYING`` (dotted-callee suffixes of the port's registry,
    in place of the reference's ``KNOWN_DONATING``), so scheduler and
    engine call sites are checked across module boundaries;
  * ``X.output`` of a captured program, overwritten by ``X.replay()``.

``jit_train_step`` is not a source: its step returns the captured state,
which every call rebinds, and ``.clone()``s of the graph's metrics
(``training/train_loop.py``).

For each source we walk the CFG forward, tracking the names that hold
the output — the statement's targets, values derived from them without a
copy (views, subscripts, shallow containers, comprehensions that do not
copy their elements) and containers they were appended or stored into:
a path that reads one of them after the same callable ran again, with no
rebind in between, is a finding.  ``.clone()`` (or any other call that
computes a new tensor) ends the alias.
"""
from __future__ import annotations

import ast
from typing import FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.staticcheck.cfgutil import CFG, EXIT
from repro_torch.analysis.staticcheck.core import (FileContext, Finding,
                                                   dotted, register)

RULE = "graph-output-alias"

# dotted-callee suffixes whose results are graph outputs on the card
KNOWN_REPLAYING: Tuple[str, ...] = (
    "._progs.step",       # serving/programs.py: prog.output
    "._progs.steps",
    "._executor",         # a StepProgram executor (scheduler A/B arms)
    "._run",              # serving/engine.py: the full_jit executor
    "._run_step",         # serving/scheduler.py: one of the two above
)
_APPEND_TAILS = {"append", "extend", "add", "appendleft", "insert", "push",
                 "update", "setdefault"}
_VIEW_METHODS = {"view", "view_as", "reshape", "squeeze", "unsqueeze",
                 "transpose", "permute", "expand", "expand_as", "narrow",
                 "select", "detach", "flatten", "unflatten", "t",
                 "as_strided", "unbind", "split", "chunk", "items",
                 "values", "get", "__getitem__"}
_CONTAINERS = {"dict", "list", "tuple", "set"}


def _match_known(d: str) -> bool:
    return any(d.endswith(key) for key in KNOWN_REPLAYING)


def _header(stmt: ast.stmt) -> ast.AST:
    """CFG nodes for compound statements are only their headers."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return stmt.iter
    if isinstance(stmt, (ast.While, ast.If)):
        return stmt.test
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return ast.Tuple(elts=[i.context_expr for i in stmt.items],
                         ctx=ast.Load())
    if isinstance(stmt, ast.Try):
        return ast.Tuple(elts=[], ctx=ast.Load())
    return stmt


def _targets(stmt: ast.stmt) -> List[ast.AST]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target]
    return []


def _names(target: ast.AST) -> Set[str]:
    """Texts a target rebinds (names and dotted attributes)."""
    out: Set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, (ast.Name, ast.Attribute)) and \
                isinstance(node.ctx, ast.Store):
            d = dotted(node)
            if d:
                out.add(d)
    return out


def _container(target: ast.AST) -> Optional[str]:
    """``x`` for a subscript store ``x[k] = ...``."""
    while isinstance(target, ast.Subscript):
        target = target.value
    return dotted(target)


class _Source:
    """One place a graph output is taken: the statement, the callable
    whose next call overwrites it and how to spot that output."""

    def __init__(self, stmt: ast.stmt, callee: str, node: ast.AST):
        self.stmt, self.callee, self.node = stmt, callee, node


class _Checker:
    def __init__(self, ctx: FileContext, fn: ast.FunctionDef,
                 replaying: Set[str]):
        self.ctx, self.fn = ctx, fn
        self.qual = ctx.qualname_of(fn)
        self.replaying = replaying
        self.cfg: Optional[CFG] = None

    # ------------------------------------------------------------ sources
    def source_of(self, node: ast.AST) -> Optional[str]:
        """The overwriting callee when ``node`` is a graph output."""
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and (d in self.replaying or _match_known(d)):
                return d
        if isinstance(node, ast.Attribute) and node.attr == "output":
            base = dotted(node.value)
            if base is not None:
                return f"{base}.replay"
        return None

    def aliases(self, node: ast.AST, held: FrozenSet[str],
                src: Optional[_Source]) -> bool:
        """Does ``node`` evaluate to (a container of) the tracked output?"""
        if src is not None and node is src.node:
            return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted(node)
            if d is not None and d in held:
                return True
            if isinstance(node, ast.Attribute):
                return self.aliases(node.value, held, src) and \
                    node.attr in ("T", "mT", "data", "real", "imag")
            return False
        if isinstance(node, ast.Subscript):
            return self.aliases(node.value, held, src)
        if isinstance(node, ast.Starred):
            return self.aliases(node.value, held, src)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.aliases(e, held, src) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.aliases(v, held, src) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.aliases(node.body, held, src) or \
                self.aliases(node.orelse, held, src)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _VIEW_METHODS:
                return self.aliases(f.value, held, src)
            if dotted(f) in _CONTAINERS:
                args = list(node.args) + [k.value for k in node.keywords]
                return any(self.aliases(a, held, src) for a in args)
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            inner = set(held)
            for gen in node.generators:
                if self.aliases(gen.iter, frozenset(inner), src):
                    inner |= _bound_names(gen.target)
            elts = ([node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            return any(self.aliases(e, frozenset(inner), src) for e in elts)
        return False

    # ---------------------------------------------------------- the walk
    def reads(self, stmt: ast.stmt, held: FrozenSet[str]) -> Optional[str]:
        """A held text that ``stmt``'s header reads, else None."""
        skip: Set[int] = set()
        for t in _targets(stmt):
            skip.update(id(n) for n in ast.walk(t)
                        if isinstance(n, (ast.Name, ast.Attribute))
                        and isinstance(n.ctx, ast.Store))
        for call in ast.walk(_header(stmt)):
            # appending to a held container reads none of its elements
            if isinstance(call, ast.Call) and isinstance(
                    call.func, ast.Attribute) and \
                    call.func.attr in _APPEND_TAILS:
                skip.add(id(call.func.value))
        for node in ast.walk(_header(stmt)):
            if id(node) in skip or not isinstance(
                    node, (ast.Name, ast.Attribute)):
                continue
            d = dotted(node)
            if d is not None and d in held:
                return d
        return None

    def calls_again(self, stmt: ast.stmt, callee: str) -> bool:
        return any(isinstance(c, ast.Call) and dotted(c.func) == callee
                   for c in ast.walk(_header(stmt)))

    def flow(self, stmt: ast.stmt, held: FrozenSet[str],
             src: Optional[_Source]) -> FrozenSet[str]:
        """``held`` after ``stmt`` runs: rebinds drop names, aliasing
        assignments and appends add them."""
        out = set(held)
        header = _header(stmt)
        value = getattr(stmt, "value", None)
        for t in _targets(stmt):
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                alias = self.aliases(stmt.iter, held, src)
            else:
                alias = value is not None and self.aliases(value, held, src)
            for name in _names(t):
                (out.add if alias else out.discard)(name)
            for node in ast.walk(t):
                if isinstance(node, ast.Subscript) and \
                        isinstance(node.ctx, ast.Store) and alias:
                    c = _container(node)
                    if c:
                        out.add(c)
        for call in ast.walk(header):
            if isinstance(call, ast.Call) and isinstance(
                    call.func, ast.Attribute) and \
                    call.func.attr in _APPEND_TAILS:
                args = list(call.args) + [k.value for k in call.keywords]
                if any(self.aliases(a, held, src) for a in args):
                    c = dotted(call.func.value)
                    if c:
                        out.add(c)
        return frozenset(out)

    def check_source(self, src: _Source) -> Optional[Finding]:
        cfg = self.cfg
        held = self.flow(src.stmt, frozenset(), src)
        if not held:
            return None
        seen: Set[Tuple[object, bool, FrozenSet[str]]] = set()
        work = [(succ, False, held) for succ in cfg.successors(id(src.stmt))]
        while work:
            node, replayed, held = work.pop()
            if (node, replayed, held) in seen or node is EXIT or not held:
                continue
            seen.add((node, replayed, held))
            stmt = cfg.stmt(node)
            if stmt is None:
                continue
            if replayed:
                name = self.reads(stmt, held)
                if name is not None:
                    return self.ctx.finding(
                        RULE, src.node,
                        f"`{name}` holds a graph output of `{src.callee}` "
                        f"and is read at line {stmt.lineno} after "
                        f"`{src.callee}` ran again — the replay overwrote "
                        f"it in place (`.clone()` it before the next call)",
                        self.qual)
            again = replayed or self.calls_again(stmt, src.callee)
            nxt = self.flow(stmt, held, None)
            for succ in cfg.successors(node):
                work.append((succ, again, nxt))
        return None


def _bound_names(target: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _replaying_bindings(tree: ast.Module) -> Set[str]:
    """Same-file names / self attributes bound to a replaying callable."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        graph_arm = (isinstance(f, ast.Attribute) and f.attr == "executor"
                     and not (node.value.args and isinstance(
                         node.value.args[0], ast.Constant)
                         and node.value.args[0].value == "eager"))
        if not graph_arm and dotted(f) != "_GraphExecutor":
            continue
        for t in node.targets:
            for name in _names(t):
                out.add(name)
    return out


@register(RULE, "a graph's outputs are not read after its next replay "
                "without a copy")
def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    replaying = _replaying_bindings(ctx.tree)
    for fn in ctx.functions():
        checker = _Checker(ctx, fn, replaying)
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.stmt):
                continue
            # anchor each source at the statement whose HEADER holds it
            for node in ast.walk(_header(stmt)):
                callee = checker.source_of(node)
                if callee is None:
                    continue
                if checker.cfg is None:
                    checker.cfg = CFG(fn)
                if id(stmt) not in checker.cfg.by_id:
                    continue       # e.g. inside a nested def
                f = checker.check_source(_Source(stmt, callee, node))
                if f is not None:
                    findings.append(f)
    return findings

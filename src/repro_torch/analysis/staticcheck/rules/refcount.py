"""refcount-pairing: every page alloc/retain reaches a release on
every path out of the function.

Copy of the reference's rule: the port's page pool
(``serving/memory/``) uses the same names.  The page pool is the
serving stack's load-bearing ledger: a page whose refcount never comes
back down is capacity lost until process restart.  A tiered page
store's restore-failure bug once had exactly this shape — pages
allocated for a restore, then a `TierCopyError` handler returned
without releasing them.  The allocator soak only catches that *after*
a chaos run; this rule catches it in the diff.

Per function, every *open* event —

  * ``v = <...>.alloc(...)`` / ``.alloc_free(...)`` /
    ``._alloc_or_preempt(...)`` (names configurable below), and
  * ``<store>.retain(x)`` calls —

starts a breadth-first walk of the statement-level CFG (`cfgutil`,
with exception edges into handlers).  A path *closes* when the pages

  * are passed to a ``release`` / ``park`` call,
  * are appended/extended into a container,
  * are stored into an attribute / subscript / other name (ownership
    transfer: ``sess.pages = got``, ``self._holds.append(got)``),
  * are returned, or
  * the variable is rebound.

``if v is None: ...`` / ``if not v:`` / ``if v:`` guards are branch-
sensitive: only the non-None arm stays open (a failed alloc holds no
pages).  Reaching EXIT while still open is a finding, reported at the
open site and naming the leaking exit statement.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.staticcheck.cfgutil import CFG, EXIT
from repro_torch.analysis.staticcheck.core import (FileContext, Finding,
                                                   dotted, register)

RULE = "refcount-pairing"

ALLOC_TAILS = {"alloc", "alloc_free", "_alloc_or_preempt", "alloc_pages"}
RETAIN_TAILS = {"retain"}
CLOSE_TAILS = {"release", "park", "release_pages", "free", "drop"}
APPEND_TAILS = {"append", "extend", "add", "appendleft", "insert", "push"}


def _callee_tail(call: ast.Call) -> Optional[str]:
    d = dotted(call.func)
    return d.rsplit(".", 1)[-1] if d else None


def _base_name(node: ast.AST) -> Optional[str]:
    """The Name a simple expr hangs off (``got``, ``got[0]``…)."""
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _mentions(node: ast.AST, var: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == var
               for n in ast.walk(node))


def _guard_polarity(test: ast.AST, var: str) -> Optional[bool]:
    """True → truthy branch holds pages; None → not a guard on var."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.comparators[0], ast.Constant) and \
            test.comparators[0].value is None and \
            isinstance(test.left, ast.Name) and test.left.id == var:
        if isinstance(test.ops[0], ast.Is):
            return False             # `v is None`: truthy arm is empty
        if isinstance(test.ops[0], ast.IsNot):
            return True
    if isinstance(test, ast.Name) and test.id == var:
        return True                  # `if v:`
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Name) \
            and test.operand.id == var:
        return False                 # `if not v:`
    return None


def _header(stmt: ast.stmt) -> ast.AST:
    """CFG nodes for compound statements are just their headers (the
    bodies are separate nodes) — don't scan into bodies here."""
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


def _closes(stmt: ast.stmt, var: str) -> bool:
    """Does executing ``stmt`` (its header, for compounds) settle
    ownership of ``var``?"""
    stmt = _header(stmt)
    # passed to release/park/…, or appended into a container
    for call in ast.walk(stmt):
        if not isinstance(call, ast.Call):
            continue
        tail = _callee_tail(call)
        args = list(call.args) + [kw.value for kw in call.keywords]
        if tail in CLOSE_TAILS | APPEND_TAILS and any(
                _mentions(a, var) for a in args):
            return True
    if isinstance(stmt, ast.Assign):
        if _mentions(stmt.value, var):
            # stored somewhere: attr/subscript = transfer; fresh name =
            # alias that now carries ownership (tracked no further)
            return True
        # rebinding the variable itself abandons the old value — treat
        # as settled to keep the rule structural, not alias-chasing
        if any(_mentions(t, var) for t in stmt.targets):
            return True
    if isinstance(stmt, ast.AugAssign) and _mentions(stmt.target, var):
        return True
    if isinstance(stmt, ast.Return) and stmt.value is not None and \
            _mentions(stmt.value, var):
        return True                  # escapes to the caller
    if isinstance(stmt, ast.Raise) and stmt.exc is not None and \
            _mentions(stmt.exc, var):
        return True
    return False


def _open_events(fn: ast.FunctionDef, cfg: CFG
                 ) -> List[Tuple[ast.stmt, str, str]]:
    """(statement, var, kind) for each alloc/retain in the CFG."""
    events = []
    for sid, stmt in cfg.by_id.items():
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call):
            tail = _callee_tail(stmt.value)
            if tail in ALLOC_TAILS and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name):
                events.append((stmt, stmt.targets[0].id, tail))
        for call in ast.walk(stmt):
            if isinstance(call, ast.Call) and \
                    _callee_tail(call) in RETAIN_TAILS and call.args:
                var = _base_name(call.args[0])
                # a retain on a *tracked variable* opens an obligation
                # only when the stmt is the bare retain call (not part
                # of a larger ownership-transferring statement)
                if var is not None and isinstance(stmt, ast.Expr) and \
                        stmt.value is call:
                    events.append((stmt, var, "retain"))
    return events


def _walk_open(ctx: FileContext, cfg: CFG, open_stmt: ast.stmt, var: str,
               kind: str, qual: str) -> Optional[Finding]:
    """BFS from the open event; a finding if any path reaches EXIT with
    the obligation still open."""
    seen: Set[object] = set()
    work: List[object] = list(cfg.successors(id(open_stmt)))
    while work:
        node = work.pop()
        if node in seen:
            continue
        seen.add(node)
        if node is EXIT:
            # fell off the function end while open
            return ctx.finding(
                RULE, open_stmt,
                f"pages from `{var} = …{kind}(…)` may leave the function "
                f"without release/park/ownership transfer (falls off the "
                f"end while held)", qual)
        stmt = cfg.stmt(node)
        if stmt is None:
            continue
        if stmt is open_stmt:
            continue                 # loop back to a re-open: fresh event
        if isinstance(stmt, ast.If):
            pol = _guard_polarity(stmt.test, var)
            if pol is not None:
                body_entry = id(stmt.body[0]) if stmt.body else None
                for succ in cfg.successors(node):
                    is_body = succ == body_entry
                    # only the pages-holding arm stays open
                    if (is_body and pol) or (not is_body and not pol):
                        work.append(succ)
                continue
        if _closes(stmt, var):
            # the close only covers paths where the statement COMPLETES;
            # an exception edge out of it (into a handler) fires before
            # the close takes effect, so the obligation stays open there
            # — this is exactly how the restore leak hid
            for succ in cfg.successors(node):
                if cfg.is_exc(node, succ):
                    work.append(succ)
            continue
        for succ in cfg.successors(node):
            if succ is EXIT and isinstance(stmt, (ast.Return, ast.Raise)):
                exit_kind = ("return" if isinstance(stmt, ast.Return)
                             else "raise")
                return ctx.finding(
                    RULE, open_stmt,
                    f"pages from `{var}` ({kind} at line "
                    f"{open_stmt.lineno}) leak on the {exit_kind} at "
                    f"line {stmt.lineno} — no release/park/ownership "
                    f"transfer on that path", qual)
            work.append(succ)
    return None


@register(RULE, "every alloc/retain is paired with release/park or an "
                "ownership transfer on all exit paths")
def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ctx.functions():
        if fn.name in ALLOC_TAILS | RETAIN_TAILS | CLOSE_TAILS:
            # delegation wrappers (PageStore.retain → allocator.retain)
            # forward the pairing obligation to their caller
            continue
        src_has = any(isinstance(n, ast.Call) and
                      _callee_tail(n) in (ALLOC_TAILS | RETAIN_TAILS)
                      for n in ast.walk(fn))
        if not src_has:
            continue
        cfg = CFG(fn)
        for open_stmt, var, kind in _open_events(fn, cfg):
            f = _walk_open(ctx, cfg, open_stmt, var, kind,
                           ctx.qualname_of(fn))
            if f is not None:
                findings.append(f)
    return findings

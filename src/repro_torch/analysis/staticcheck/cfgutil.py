"""A small statement-level CFG over one function body.

Copy of ``repro.analysis.staticcheck.cfgutil`` (nothing in it depends
on the language of the scanned code).  Built for the
``refcount-pairing`` rule, which must prove that every page allocation
reaches a release / park / ownership transfer on EVERY path out of the
function — including ``except`` handlers and early returns, the edge a
tiered page store's restore-failure leak once hid on — and walked by
``graph-output-alias`` too.

Nodes are the function's AST statements; edges:

  * sequential statement flow, ``if``/``else`` branch + merge;
  * loops: body entry + fall-through, back-edge to the header,
    ``break``/``continue``;
  * ``try``: every statement in the try body gets an edge to every
    handler entry (an exception can fire anywhere inside), handlers
    and ``else`` merge after; ``finally`` runs on the merge path
    (approximation: the abrupt-completion re-raise path through
    ``finally`` is not modelled separately);
  * ``return``/``raise`` → the synthetic EXIT node.

This is an over-approximation in the usual ways (both branches of
every ``if`` are considered reachable, loop bodies run 0+ times) —
fine for a linter whose findings name a concrete structural path.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

EXIT = "<exit>"


class CFG:
    """successors: id(stmt) -> set of id(stmt) | EXIT."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.succ: Dict[object, Set[object]] = {}
        self.entry: Optional[object] = None
        self.exit_stmts: Dict[object, ast.stmt] = {}   # stmts edging to EXIT
        self.by_id: Dict[object, ast.stmt] = {}
        # (frm, to) pairs that model an exception jumping into a handler
        # — the source statement did NOT complete on these edges
        self.exc_edges: Set[Tuple[object, object]] = set()
        if fn.body:
            self.entry = id(fn.body[0])
        last = self._seq(fn.body, loop=None, handlers=())
        for node in last:
            self._edge(node, EXIT)

    # ------------------------------------------------------------ building
    def _edge(self, frm, to, exc: bool = False) -> None:
        self.succ.setdefault(frm, set()).add(to)
        if exc:
            self.exc_edges.add((frm, to))
        if to is EXIT and frm in self.by_id:
            self.exit_stmts[frm] = self.by_id[frm]

    def _seq(self, body: List[ast.stmt], loop, handlers) -> List[object]:
        """Wire ``body`` sequentially; returns the dangling nodes whose
        successor is whatever follows the sequence.  ``loop`` is
        (header_id, break_sinks) of the innermost loop; ``handlers`` the
        entry ids of enclosing except handlers (for exception edges)."""
        dangling: List[object] = []
        prev: List[object] = []
        for stmt in body:
            sid = id(stmt)
            self.by_id[sid] = stmt
            for p in prev:
                self._edge(p, sid)
            # any statement inside a try body may raise into a handler
            for h in handlers:
                self._edge(sid, h, exc=True)
            prev = self._stmt(stmt, loop, handlers)
        dangling.extend(prev)
        return dangling

    def _stmt(self, stmt: ast.stmt, loop, handlers) -> List[object]:
        sid = id(stmt)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._edge(sid, EXIT)
            return []
        if isinstance(stmt, ast.Break):
            if loop is not None:
                loop[1].append(sid)
            return []
        if isinstance(stmt, ast.Continue):
            if loop is not None:
                self._edge(sid, loop[0])
            return []
        if isinstance(stmt, ast.If):
            out = []
            for branch in (stmt.body, stmt.orelse):
                if branch:
                    self._edge(sid, id(branch[0]))
                    out.extend(self._seq(branch, loop, handlers))
                else:
                    out.append(sid)       # no else: fall through
            return out
        if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            breaks: List[object] = []
            if stmt.body:
                self._edge(sid, id(stmt.body[0]))
                for tail in self._seq(stmt.body, (sid, breaks), handlers):
                    self._edge(tail, sid)          # back edge
            out = list(breaks)
            infinite = (isinstance(stmt, ast.While)
                        and isinstance(stmt.test, ast.Constant)
                        and bool(stmt.test.value) and not stmt.orelse)
            if not infinite:
                if stmt.orelse:
                    self._edge(sid, id(stmt.orelse[0]))
                    out.extend(self._seq(stmt.orelse, loop, handlers))
                else:
                    out.append(sid)                # zero-iteration path
            return out
        if isinstance(stmt, ast.Try):
            h_entries = tuple(id(h.body[0]) for h in stmt.handlers
                              if h.body)
            out = []
            if stmt.body:
                self._edge(sid, id(stmt.body[0]))
                body_tail = self._seq(stmt.body, loop,
                                      h_entries + tuple(handlers))
            else:
                body_tail = [sid]
            for h in stmt.handlers:
                if h.body:
                    # the handler's first stmt is reachable from any
                    # try-body stmt (wired in _seq); record its own flow
                    self.by_id[id(h.body[0])] = h.body[0]
                    out.extend(self._seq(h.body, loop, handlers))
            if stmt.orelse:
                for t in body_tail:
                    self._edge(t, id(stmt.orelse[0]))
                out.extend(self._seq(stmt.orelse, loop, handlers))
            else:
                out.extend(body_tail)
            if stmt.finalbody:
                for t in out:
                    self._edge(t, id(stmt.finalbody[0]))
                out = self._seq(stmt.finalbody, loop, handlers)
            return out
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            if stmt.body:
                self._edge(sid, id(stmt.body[0]))
                return self._seq(stmt.body, loop, handlers)
            return [sid]
        return [sid]

    # ----------------------------------------------------------- traversal
    def successors(self, node) -> Set[object]:
        return self.succ.get(node, set())

    def is_exc(self, frm, to) -> bool:
        return (frm, to) in self.exc_edges

    def stmt(self, node) -> Optional[ast.stmt]:
        return self.by_id.get(node)


def statements_after(cfg: CFG, start: ast.stmt
                     ) -> List[Tuple[object, ast.stmt]]:
    """All (id, stmt) reachable from (excluding) ``start``."""
    seen: Set[object] = set()
    work = list(cfg.successors(id(start)))
    out = []
    while work:
        node = work.pop()
        if node in seen or node is EXIT:
            continue
        seen.add(node)
        st = cfg.stmt(node)
        if st is not None:
            out.append((node, st))
        work.extend(cfg.successors(node))
    return out

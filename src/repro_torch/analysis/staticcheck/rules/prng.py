"""generator-discipline: random draws come from a generator the caller owns.

Port of the reference's ``prng-discipline``.  A JAX key is a value, so
the reference asks that each key feed one consumer.  A torch
``Generator`` is state: each draw moves it on, so the hazards differ.

  * A random op without ``generator=`` in a hot function draws from the
    process-wide default generator: its stream depends on every other
    draw in the process, so a seeded session cannot be replayed, and a
    captured graph that draws from it raises (only generators registered
    with the graph may be drawn from inside a capture).
  * A ``torch.Generator(...)`` built inside a loop or a hot function
    allocates a generator (and its device state) per iteration or per
    call, and, seeded alike, restarts the same stream each time.
  * Two generators seeded with the same expression in one function give
    the same stream: the "two consumers of one key" of the reference.

The pass walks each function linearly (loop bodies twice, so that a
seed that repeats from one iteration to the next shows up), keying each
``manual_seed(expr)`` by the text of ``expr`` and the generation of each
name in it: a rebinding — a loop's target on every pass — gives a new
seed.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.staticcheck.core import (FileContext, Finding,
                                                   dotted, register)

RULE = "generator-discipline"

# torch functions and tensor methods that draw from a generator
_RANDOM = {"rand", "rand_like", "randn", "randn_like", "randint",
           "randint_like", "randperm", "bernoulli", "multinomial",
           "normal", "poisson", "exponential_", "normal_", "uniform_",
           "bernoulli_", "random_", "geometric_", "cauchy_",
           "log_normal_"}
_TENSOR_ONLY = {"exponential_", "normal_", "uniform_", "bernoulli_",
                "random_", "geometric_", "cauchy_", "log_normal_"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def _draws(call: ast.Call) -> bool:
    """A random op: ``torch.<op>(...)`` or ``<tensor>.<op>_(...)``."""
    if not isinstance(call.func, ast.Attribute) or \
            call.func.attr not in _RANDOM:
        return False
    if call.func.attr in _TENSOR_ONLY:
        return True
    return dotted(call.func.value) == "torch"


def _is_generator(call: ast.Call) -> bool:
    return dotted(call.func) in ("torch.Generator", "Generator")


class _Walker:
    def __init__(self, ctx: FileContext, fn: ast.FunctionDef):
        self.ctx, self.fn = ctx, fn
        self.qual = ctx.qualname_of(fn)
        self.hot = ctx.directives.is_hotpath_def(fn.lineno)
        self.gen: Dict[str, int] = {}          # name -> generation
        self.seeds: Dict[Tuple[str, Tuple[int, ...]], int] = {}
        self.findings: List[Finding] = []
        self.reported: Set[Tuple[int, int, str]] = set()
        self.loops = 0

    def _flag(self, node: ast.AST, message: str) -> None:
        mark = (node.lineno, node.col_offset, message)
        if mark not in self.reported:
            self.reported.add(mark)
            self.findings.append(self.ctx.finding(RULE, node, message,
                                                  self.qual))

    def _bump(self, target: ast.AST) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                self.gen[node.id] = self.gen.get(node.id, 0) + 1

    def _seed_key(self, expr: ast.AST) -> Tuple[str, Tuple[int, ...]]:
        names = sorted({n.id for n in ast.walk(expr)
                        if isinstance(n, ast.Name)})
        return ast.dump(expr), tuple(self.gen.get(n, 0) for n in names)

    # ----------------------------------------------------------- the walk
    def walk(self) -> List[Finding]:
        self._body(self.fn.body)
        return self.findings

    def _body(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, _LOOPS):
            self._expr(stmt.test if isinstance(stmt, ast.While)
                       else stmt.iter)
            self.loops += 1
            for _ in range(2):
                if not isinstance(stmt, ast.While):
                    self._bump(stmt.target)
                self._body(stmt.body)
            self.loops -= 1
            self._body(stmt.orelse)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test)
            # branches exclude each other: seeds of one do not meet the
            # other's; afterwards both count
            before = dict(self.seeds)
            self._body(stmt.body)
            after_body = self.seeds
            self.seeds = dict(before)
            self._body(stmt.orelse)
            for key, line in after_body.items():
                self.seeds.setdefault(key, line)
            return
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, *[h.body for h in stmt.handlers],
                         stmt.orelse, stmt.finalbody):
                self._body(part)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
            self._body(stmt.body)
            return
        self._expr(stmt)
        for t in (stmt.targets if isinstance(stmt, ast.Assign) else
                  [stmt.target] if isinstance(stmt, (ast.AugAssign,
                                                     ast.AnnAssign)) else []):
            self._bump(t)

    def _expr(self, node: ast.AST) -> None:
        in_comp = set()
        for sub in ast.walk(node):
            if isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                in_comp.update(id(n) for n in ast.walk(sub))
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            if self.hot and _draws(call) and not any(
                    kw.arg == "generator" for kw in call.keywords):
                self._flag(call, f"`{ast.unparse(call.func)}` without "
                                 f"`generator=` inside hot-path function "
                                 f"(draws from the process-wide default "
                                 f"generator; pass the caller's)")
            if _is_generator(call):
                where = ("inside a loop/comprehension"
                         if self.loops or id(call) in in_comp else
                         "inside hot-path function" if self.hot else None)
                if where:
                    self._flag(call, f"`torch.Generator(...)` built {where} "
                                     f"(one generator per iteration or "
                                     f"call; build it once and reuse it)")
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr == "manual_seed" and call.args:
                key = self._seed_key(call.args[0])
                first = self.seeds.get(key)
                if first is None:
                    self.seeds[key] = call.lineno
                else:
                    self._flag(call, f"a generator seeded with "
                                     f"`{ast.unparse(call.args[0])}` again "
                                     f"(first at line {first}) — both "
                                     f"give the same stream")


@register(RULE, "random draws on the hot path name their generator; "
                "generators are built once and seeded apart")
def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ctx.functions():
        findings.extend(_Walker(ctx, fn).walk())
    return findings

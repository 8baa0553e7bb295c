"""torchcheck engine: rule registry, directives, baseline, reporting.

Port of ``repro.analysis.staticcheck.core``.  The port's serving stack
rests on the same invariants as the reference's: the decode tick is one
captured CUDA graph, nothing on the hot path makes the host wait for the
card but the one read of the sampled tokens, no KV page leaks.  Each is
held dynamically by tests and by ``chip_smoke.py``'s runs on the card;
this package holds them statically, at lint time, over the AST.

Vocabulary:

  * **Rule** — a named AST pass over one file (``rules/``).  Each rule
    guards one invariant and reports ``Finding``s.
  * **Directive** — a ``# torchcheck: ...`` comment in the scanned
    source.  ``disable=<rule>[,<rule>...] [-- justification]``
    suppresses matching findings on its line (or, on a comment line of
    its own, the next line that is not a comment); ``hotpath``
    designates the function defined on / below it as a serving hot path
    (consumed by the ``hot-sync`` and ``generator-discipline`` rules).
    Suppressions that match no finding are themselves findings
    (``unused-suppression``) — dead suppressions hide future
    regressions.
  * **Baseline** — a JSON file of grandfathered findings (matched by a
    line-insensitive fingerprint) with a *mandatory written
    justification* per entry; an empty justification fails the run.

The one change from the reference is the prefix.  The reference's
checker scans this package's tree too, and reports every
``# staticcheck: disable=...`` that matches none of *its* findings, so
this checker's suppressions carry a prefix of their own.  Hot paths are
marked once for both: ``# staticcheck: hotpath`` (and ``# torchcheck:
hotpath``) designate a hot function here, while ``# staticcheck:
disable=...`` belongs to the reference and is neither honoured nor
reported.  Because a directive on a line of its own here aims at the
next line that is not a comment, the two stack above one statement with
the reference's directly above the code::

    # torchcheck: disable=hot-sync -- why the port must sync here
    # staticcheck: disable=hot-sync -- why the reference must
    nxt = np.asarray(nxt.cpu())

``check_source`` / ``check_file`` run the pipeline on one buffer/file;
``run_paths`` walks trees; ``hot_functions`` lists the designated hot
paths; the CLI lives in ``cli.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import tokenize
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

DIRECTIVE_PREFIX = "torchcheck:"
REFERENCE_PREFIX = "staticcheck:"      # read for ``hotpath`` only
UNUSED_SUPPRESSION = "unused-suppression"
PARSE_ERROR = "parse-error"


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location.

    ``context`` is the enclosing function's qualified name (or
    ``<module>``); fingerprints hash (rule, path, context, message) but
    NOT the line, so baselines survive unrelated edits above them."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str = "<module>"
    baselined: bool = False

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.context}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message} [{self.context}]")

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


@dataclasses.dataclass
class Suppression:
    line: int            # line the suppression applies to
    comment_line: int    # line the directive comment sits on
    rules: Tuple[str, ...]
    justification: str
    used: bool = False

    def covers(self, finding: Finding) -> bool:
        return finding.line == self.line and (
            "all" in self.rules or finding.rule in self.rules)


class Directives:
    """Parsed ``# torchcheck:`` (and ``# staticcheck: hotpath``)
    comments of one file."""

    def __init__(self, suppressions: List[Suppression],
                 hotpath_lines: frozenset):
        self.suppressions = suppressions
        self.hotpath_lines = hotpath_lines

    def is_hotpath_def(self, def_line: int) -> bool:
        """A def is hot when the marker sits on the def line or the
        line directly above it (above any decorators counts too)."""
        return (def_line in self.hotpath_lines
                or def_line - 1 in self.hotpath_lines)


def _parse_directive(text: str, comment_line: int, target: int
                     ) -> Tuple[Optional[Suppression], bool]:
    """Parse one comment's directive → (suppression | None, is_hotpath).
    ``target`` is the line a suppression applies to."""
    prefix = next(p for p in (DIRECTIVE_PREFIX, REFERENCE_PREFIX)
                  if text.startswith(p))
    body = text[len(prefix):].strip()
    if body == "hotpath":
        return None, True
    if prefix == DIRECTIVE_PREFIX and body.startswith("disable="):
        rest = body[len("disable="):]
        justification = ""
        if "--" in rest:
            rest, justification = rest.split("--", 1)
            justification = justification.strip()
        rules = tuple(r.strip() for r in rest.split(",") if r.strip())
        return Suppression(target, comment_line, rules, justification), False
    return None, False


def scan_directives(src: str) -> Directives:
    suppressions: List[Suppression] = []
    hotpath: set = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError):
        return Directives([], frozenset())
    lines = src.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        text = tok.string.lstrip("#").strip()
        if not text.startswith((DIRECTIVE_PREFIX, REFERENCE_PREFIX)):
            continue
        line_no = tok.start[0]
        code_before = lines[line_no - 1][:tok.start[1]].strip()
        # a trailing directive designates its own line; a standalone one
        # the next line that is not a comment (so that it can stack with
        # the reference's directives, which aim at the very next line)
        target = line_no
        if not code_before:
            target += 1
            while target <= len(lines) and \
                    lines[target - 1].lstrip().startswith("#"):
                target += 1
        supp, is_hot = _parse_directive(text, line_no, target)
        if supp is not None:
            suppressions.append(supp)
        if is_hot:
            hotpath.add(target)
    return Directives(suppressions, frozenset(hotpath))


class FileContext:
    """Everything one rule pass needs about one file."""

    def __init__(self, path: str, src: str, tree: ast.Module,
                 directives: Directives):
        self.path = path
        self.src = src
        self.tree = tree
        self.directives = directives
        self._qualnames: Dict[int, str] = {}
        self._index_scopes()

    def _index_scopes(self) -> None:
        def walk(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    self._mark(child, q)
                    walk(child, q)
                elif isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    walk(child, q)
                else:
                    walk(child, prefix)
        walk(self.tree, "")

    def _mark(self, fn: ast.AST, qualname: str) -> None:
        # keyed by function node id: unambiguous for nested defs
        self._qualnames[id(fn)] = qualname

    def qualname_of(self, fn: ast.AST) -> str:
        return self._qualnames.get(id(fn), getattr(fn, "name", "<module>"))

    def finding(self, rule: str, node: ast.AST, message: str,
                context: str = "<module>") -> Finding:
        return Finding(rule, self.path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message, context)

    def functions(self) -> Iterable[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


# --------------------------------------------------------------- registry
@dataclasses.dataclass
class Rule:
    name: str
    invariant: str                      # one-line invariant guarded
    check: Callable[[FileContext], List[Finding]]


RULES: Dict[str, Rule] = {}


def register(name: str, invariant: str):
    """Decorator: register ``fn(ctx) -> [Finding]`` as rule ``name``."""
    def deco(fn):
        assert name not in RULES, f"duplicate rule {name}"
        RULES[name] = Rule(name, invariant, fn)
        return fn
    return deco


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None (shared helper:
    most rules match callees by their dotted text)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set:
    """All Name ids read anywhere inside ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ----------------------------------------------------------------- checking
def check_source(src: str, path: str = "<string>",
                 select: Optional[Sequence[str]] = None,
                 suppressed: Optional[List[Tuple[Finding, Suppression]]]
                 = None) -> List[Finding]:
    """Run the (selected) rules over one source buffer, apply
    suppressions, and append unused-suppression findings.  Returns the
    surviving findings — baseline filtering is the caller's job.  Each
    finding a suppression covers is appended to ``suppressed``, when
    given, with that suppression."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(PARSE_ERROR, path, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    directives = scan_directives(src)
    ctx = FileContext(path, src, tree, directives)
    findings: List[Finding] = []
    for rule in RULES.values():
        if select and rule.name not in select:
            continue
        findings.extend(rule.check(ctx))
    kept: List[Finding] = []
    for f in findings:
        supp = next((s for s in directives.suppressions if s.covers(f)),
                    None)
        if supp is not None:
            supp.used = True
            if suppressed is not None:
                suppressed.append((f, supp))
        else:
            kept.append(f)
    for s in directives.suppressions:
        if not s.used and (select is None
                           or any(r in select or r == "all"
                                  for r in s.rules)):
            kept.append(Finding(
                UNUSED_SUPPRESSION, path, s.comment_line, 0,
                f"suppression of {', '.join(s.rules)} matches no finding",
            ))
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def check_file(path: str, rel: Optional[str] = None,
               select: Optional[Sequence[str]] = None,
               suppressed: Optional[list] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return check_source(src, rel or path, select, suppressed)


def iter_py_files(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """(abs, display) pairs for every .py under ``paths`` (files pass
    through), sorted for deterministic reports."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append((p, p))
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for name in sorted(files):
                if name.endswith(".py"):
                    full = os.path.join(root, name)
                    out.append((full, os.path.relpath(full)))
    return sorted(out, key=lambda t: t[1])


def run_paths(paths: Sequence[str],
              select: Optional[Sequence[str]] = None,
              suppressed: Optional[list] = None
              ) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    files = iter_py_files(paths)
    for full, rel in files:
        findings.extend(check_file(full, rel, select, suppressed))
    return findings, len(files)


def hot_functions(paths: Sequence[str]) -> List[Tuple[str, str, int]]:
    """(display path, qualified name, def line) of every function a
    ``hotpath`` marker designates under ``paths``."""
    out = []
    for full, rel in iter_py_files(paths):
        with open(full, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        ctx = FileContext(rel, src, tree, scan_directives(src))
        out.extend((rel, ctx.qualname_of(fn), fn.lineno)
                   for fn in ctx.functions()
                   if ctx.directives.is_hotpath_def(fn.lineno))
    return sorted(out, key=lambda t: (t[0], t[2]))


# ----------------------------------------------------------------- baseline
def load_baseline(path: str) -> Dict[str, Dict]:
    """fingerprint -> entry.  Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {e["fingerprint"]: e for e in data.get("entries", [])}


def write_baseline(path: str, findings: Sequence[Finding],
                   old: Dict[str, Dict]) -> int:
    """Write ``findings`` as the new baseline, keeping justifications
    already written for surviving fingerprints.  Returns the number of
    entries that still need a justification filled in."""
    entries, empty = [], 0
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        fp = f.fingerprint()
        just = old.get(fp, {}).get("justification", "")
        empty += not just
        entries.append({"fingerprint": fp, "rule": f.rule, "path": f.path,
                        "context": f.context, "message": f.message,
                        "justification": just})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2)
        fh.write("\n")
    return empty


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, Dict]
                   ) -> Tuple[List[Finding], List[Finding], List[Dict],
                              List[Dict]]:
    """Split into (new, grandfathered, stale-entries, unjustified).

    ``unused-suppression`` findings are never baselineable — a dead
    suppression must be deleted, not grandfathered."""
    new, old_hits, seen = [], [], set()
    for f in findings:
        fp = f.fingerprint()
        if f.rule != UNUSED_SUPPRESSION and fp in baseline:
            f.baselined = True
            seen.add(fp)
            old_hits.append(f)
        else:
            new.append(f)
    stale = [e for fp, e in baseline.items() if fp not in seen]
    unjustified = [e for fp, e in baseline.items()
                   if fp in seen and not e.get("justification")]
    return new, old_hits, stale, unjustified

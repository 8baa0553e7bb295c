"""hot-sync: nothing on the decode hot path makes the host wait for the card.

Port of the reference's rule to PyTorch.  Batch-1 decode on the card is
held back by the host, and the cheapest way to make it worse is an
accidental read of a device tensor (``int(t)``, ``.item()``, ``if
t.any():``) or a blocking copy inside the tick loop: the host stops
until the card has drained its queue, and the next launch waits for the
host.  Functions designated ``# staticcheck: hotpath`` (or ``#
torchcheck: hotpath``) must funnel ALL device reads through their one
deliberate sync.

Mechanics: a linear walk of each hot function tracks which names and
dotted attributes hold device tensors (results of ``torch.*`` calls
other than host factories, of tensor methods on device values, of the
program registry ``._progs.*`` / ``._executor`` / ``._run``, of the known
device-producing methods, and parameters annotated ``torch.Tensor``),
which hold host tensors or arrays (``np.*``, ``torch.from_numpy``, host
factories, ``.cpu()`` / ``.numpy()``) and which of those are page-locked
(``.pin_memory()``, ``pin_memory=True``).  Flagged:

  * ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.synchronize()`` (a ``Stream`` or ``Event``) and
    ``torch.cuda.synchronize`` anywhere in a hot function (the first
    four are skipped on a known host value), ``.to("cpu")`` unless
    ``non_blocking=True``, and calls of ``KNOWN_SYNCING`` helpers;
  * ``int`` / ``float`` / ``bool`` / ``np.asarray`` / ``np.array`` of a
    device value, and the implicit ``bool`` of a device value in an
    ``if`` / ``while`` / conditional expression / ``assert`` test, under
    ``not`` or as an operand of ``and`` / ``or`` (``if (x > 0).any():``);
  * ops whose output shape depends on the data, which read a count back
    before they can allocate: ``nonzero``, ``argwhere``, one-argument
    ``torch.where``, ``masked_select``, ``unique``,
    ``unique_consecutive``, indexing with a boolean device mask
    (``x[x > 0]``), and ``repeat_interleave`` with tensor repeats and no
    ``output_size``;
  * copies from the host to the card that make the host wait:
    ``.to(<device>)`` / ``.copy_(<host>)`` without ``non_blocking=True``
    (torch waits for the copy to end), from pageable memory even with
    ``non_blocking=True`` (CUDA waits for the stream before it stages a
    pageable copy; torch's detector does not see this one),
    ``torch.tensor`` / ``torch.as_tensor`` of host data with a card
    ``device``, and a pageable host tensor passed to a device program
    (a call of the registry or of a device-producing method), which
    copies it to the card inside.

Blocks gated on a ``timed`` flag (``if self.timed:``) are exempt —
instrumentation is allowed to sync when the caller asked for walls.  The
deliberate once-per-tick token sync carries a suppression naming itself.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.staticcheck.core import (FileContext, Finding,
                                                   dotted, register)

RULE = "hot-sync"

DEVICE, HOST, PINNED = "device", "host", "pinned"

# helpers that synchronise on purpose: dotted-callee suffix -> what they do
KNOWN_SYNCING: Dict[str, str] = {
    "._sync": "serving/engine.py's `_sync`: torch.cuda.synchronize on the "
              "engine's card",
}
# callee dotted-name shapes whose results live on the card
_DEVICE_INFIX = ("._progs.",)
_DEVICE_SUFFIX = ("._executor", "._run")
_DEVICE_TAILS = {
    "_run_step", "_sample", "sample", "decode_step", "decode_steps",
    "prefill", "prefill_chunk", "prefill_into_slot",
    "prefill_chunk_into_slot", "copy_kv_page", "_step", "_steps_fused",
    "_prefill", "save_kv_pages", "restore_kv_pages",
}
_HOST_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array"}
_SCALAR_SYNCS = {"int", "float", "bool"}
_ALWAYS_SYNC_CALLS = {"torch.cuda.synchronize"}
_READ_METHODS = {"item", "tolist", "cpu", "numpy"}     # device -> host
# torch.* calls that return no tensor
_TORCH_NON_TENSOR = ("torch.cuda.", "torch.device", "torch.Generator",
                     "torch.no_grad", "torch.inference_mode",
                     "torch.manual_seed", "torch.is_tensor", "torch.Size",
                     "torch.finfo", "torch.iinfo", "torch.get_default_dtype",
                     "torch.autograd.", "torch.backends.")
# torch factories: on the host unless given a card ``device``
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
              "as_tensor", "rand", "randn", "randint", "randperm",
              "linspace", "eye"}
# tensor methods that return host metadata, not tensors
_META_METHODS = {"dim", "size", "numel", "stride", "data_ptr",
                 "element_size", "is_contiguous", "nelement", "get_device",
                 "storage_offset", "is_pinned", "__len__"}
_VIEW_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data"}
_DATA_DEPENDENT = {"nonzero", "argwhere", "masked_select", "unique",
                   "unique_consecutive"}
_MASK_TAILS = {"isnan", "isinf", "isfinite", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "lt", "le", "gt", "ge", "bool", "isin"}
_IDENTITY_OPS = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
_TIMED_GATES = {"timed"}


def _tail(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return dotted(call.func)


def _keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def _true(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device" \
            and node.args:
        return _is_cpu(node.args[0])
    return False


def _is_device_arg(node: ast.AST) -> bool:
    """A device, not a dtype: a device string, ``torch.device(...)``, or
    a name or attribute that ends in ``device`` / ``dev``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cpu", "cuda", "meta")
    if isinstance(node, ast.Call):
        return dotted(node.func) == "torch.device"
    d = dotted(node)
    return d is not None and d.rsplit(".", 1)[-1] in ("device", "dev")


def _to_target(call: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to, else None (a dtype)."""
    dev = _keyword(call, "device")
    if dev is not None:
        return dev
    if call.args and _is_device_arg(call.args[0]):
        return call.args[0]
    return None


def _timed_gated(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in _TIMED_GATES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _TIMED_GATES:
            return True
    return False


def _known_syncing(d: str) -> Optional[str]:
    return next((key for key in KNOWN_SYNCING if d.endswith(key)), None)


class _HotWalker:
    def __init__(self, ctx: FileContext, fn: ast.FunctionDef):
        self.ctx = ctx
        self.fn = fn
        self.qual = ctx.qualname_of(fn)
        # name / dotted attribute -> DEVICE | HOST | PINNED
        self.kind: Dict[str, str] = {}
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
            if a.annotation is not None and \
                    "Tensor" in ast.unparse(a.annotation):
                self.kind[a.arg] = DEVICE
        self.masks: Set[str] = set()       # names holding a device bool mask
        self.findings: List[Finding] = []
        self._seen: Set[int] = set()

    # ------------------------------------------------------------- kinds
    def kind_of(self, node: ast.AST) -> Optional[str]:
        """DEVICE / HOST / PINNED for an expression that is a tensor (or
        array) whose side is known, else None."""
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted(node)
            if d is not None and d in self.kind:
                return self.kind[d]
            if isinstance(node, ast.Attribute):
                if node.attr in _VIEW_ATTRS:
                    return self.kind_of(node.value)
            return None
        if isinstance(node, ast.Subscript):
            k = self.kind_of(node.value)
            return HOST if k == PINNED else k      # a slice: a new tensor
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        if isinstance(node, ast.BinOp):
            return self._join(node.left, node.right)
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return None                          # a Python bool
            return self._join(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, _IDENTITY_OPS) for op in node.ops):
                return None
            return self._join(node.left, *node.comparators)
        if isinstance(node, ast.BoolOp):
            return self._join(*node.values)
        if isinstance(node, ast.IfExp):
            return self._join(node.body, node.orelse)
        return None

    def _join(self, *nodes: ast.AST) -> Optional[str]:
        kinds = {self.kind_of(n) for n in nodes}
        if DEVICE in kinds:
            return DEVICE
        if kinds & {HOST, PINNED}:
            return HOST
        return None

    def _call_kind(self, call: ast.Call) -> Optional[str]:
        d = dotted(call.func)
        if d is not None:
            if d in _HOST_CONVERTERS or d.split(".")[0] in ("np", "numpy"):
                return HOST
            if d == "torch.from_numpy":
                return HOST
            if d in _SCALAR_SYNCS:
                return None
            if d.startswith("torch."):
                if d.startswith(_TORCH_NON_TENSOR):
                    return None
                name = d.rsplit(".", 1)[-1]
                if name in _FACTORIES:
                    return self._factory_kind(call)
                if name.endswith("_like"):
                    dev = _keyword(call, "device")
                    if dev is not None:
                        return HOST if _is_cpu(dev) else DEVICE
                    return self._join(*call.args[:1])
                # ops follow their inputs; torch.* defaults to the card
                return self._join(*call.args) or DEVICE
            if any(i in d for i in _DEVICE_INFIX) or \
                    d.endswith(_DEVICE_SUFFIX) or \
                    d.rsplit(".", 1)[-1] in _DEVICE_TAILS:
                return DEVICE
        if isinstance(call.func, ast.Attribute):
            m = call.func.attr
            recv = self.kind_of(call.func.value)
            if m in ("cpu", "numpy", "tolist", "item"):
                return HOST if m in ("cpu", "numpy") else None
            if m == "pin_memory":
                return PINNED
            if m == "to":
                target = _to_target(call)
                if target is not None:
                    return HOST if _is_cpu(target) else DEVICE
                return recv
            if m in _META_METHODS:
                return None
            if recv is not None:
                return HOST if recv == PINNED else recv
        return None

    def _factory_kind(self, call: ast.Call) -> str:
        dev = _keyword(call, "device")
        if dev is not None and not _is_cpu(dev):
            return DEVICE
        return PINNED if _true(_keyword(call, "pin_memory")) else HOST

    def _is_mask(self, node: ast.AST) -> bool:
        """A boolean tensor on the card (for ``x[mask]``)."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.kind_of(node) == DEVICE
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        if isinstance(node, ast.Call):
            return _tail(node) in _MASK_TAILS and \
                self.kind_of(node) == DEVICE
        return False

    # ------------------------------------------------------------ flags
    def _flag(self, node: ast.AST, what: str) -> None:
        if id(node) in self._seen:
            return
        self._seen.add(id(node))
        self.findings.append(self.ctx.finding(
            RULE, node,
            f"{what} inside hot-path function (device→host sync on the "
            f"decode tick; gate on `timed` or move off the hot path)",
            self.qual))

    def _truth(self, node: ast.AST) -> None:
        """``node`` is tested for truth: flag a device value there."""
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self._truth(v)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            self._truth(node.operand)
        elif self.kind_of(node) == DEVICE:
            self._flag(node, "implicit `bool()` of a device value")

    def _scan_expr(self, node: ast.AST) -> None:
        """Flag syncs anywhere inside one expression tree."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.BoolOp):
                for v in sub.values[:-1]:
                    self._truth(v)
            elif isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
                self._truth(sub.operand)
            elif isinstance(sub, ast.IfExp):
                self._truth(sub.test)
            elif isinstance(sub, ast.comprehension):
                for cond in sub.ifs:
                    self._truth(cond)
            elif isinstance(sub, ast.Subscript) and \
                    isinstance(sub.ctx, ast.Load) and \
                    self.kind_of(sub.value) == DEVICE and \
                    self._is_mask(sub.slice):
                self._flag(sub, "indexing with a boolean mask (its size "
                                "is read back)")
            elif isinstance(sub, ast.Call):
                self._scan_call(sub)

    def _scan_call(self, call: ast.Call) -> None:
        d = dotted(call.func)
        m = call.func.attr if isinstance(call.func, ast.Attribute) else None
        recv = self.kind_of(call.func.value) if m else None
        if d in _ALWAYS_SYNC_CALLS:
            self._flag(call, f"`{d}(...)`")
        elif d is not None and _known_syncing(d):
            self._flag(call, f"`{d}()` (a known syncing helper: "
                             f"{KNOWN_SYNCING[_known_syncing(d)]})")
        elif m == "synchronize":
            self._flag(call, "`.synchronize()`")
        elif m in _READ_METHODS and recv not in (HOST, PINNED) and \
                not (d or "").startswith(("np.", "numpy.")):
            self._flag(call, f"`.{m}()`")
        elif m == "to":
            self._scan_to(call, recv)
        elif m == "copy_" and call.args and recv not in (HOST, PINNED):
            self._scan_upload(call, self.kind_of(call.args[0]), "`.copy_()`")
        elif d in _HOST_CONVERTERS:
            if call.args and self.kind_of(call.args[0]) == DEVICE:
                self._flag(call, f"`{d}` on a device value")
        elif d in _SCALAR_SYNCS:
            if call.args and self.kind_of(call.args[0]) == DEVICE:
                self._flag(call, f"`{d}()` on a device value")
        elif d in ("torch.tensor", "torch.as_tensor"):
            dev = _keyword(call, "device")
            if dev is not None and not _is_cpu(dev) and call.args and \
                    self.kind_of(call.args[0]) != DEVICE:
                self._flag(call, f"`{d}` of host data onto the card (a "
                                 f"blocking copy from pageable memory)")
        elif d == "torch.where" and len(call.args) == 1 \
                and not call.keywords:
            self._flag(call, "one-argument `torch.where` (a nonzero: its "
                             "size is read back)")
        elif (_tail(call) or "").rsplit(".", 1)[-1] in _DATA_DEPENDENT and (
                (d or "").startswith("torch.")
                or (m and recv not in (HOST, PINNED)
                    and not (d or "").startswith(("np.", "numpy.")))):
            self._flag(call, f"`{_tail(call).rsplit('.', 1)[-1]}` (its "
                             f"output size is read back)")
        elif (_tail(call) or "").endswith("repeat_interleave"):
            self._scan_repeat(call, d, recv)
        if d is not None and not d.startswith("torch.") and \
                self._call_kind(call) == DEVICE:
            for arg in list(call.args) + [k.value for k in call.keywords]:
                if self.kind_of(arg) == HOST:
                    self._flag(arg, f"a pageable host tensor passed to "
                                    f"`{d}` (the device program copies it "
                                    f"to the card, and the copy blocks)")

    def _scan_to(self, call: ast.Call, recv: Optional[str]) -> None:
        target = _to_target(call)
        if target is None:
            return
        if _is_cpu(target):
            if not _true(_keyword(call, "non_blocking")):
                self._flag(call, '`.to("cpu")`')
            return
        if recv in (HOST, PINNED):
            self._scan_upload(call, recv, "`.to(<device>)`")

    def _scan_upload(self, call: ast.Call, src: Optional[str],
                     what: str) -> None:
        """A copy onto the card from ``src``'s side of it."""
        if src == HOST:
            self._flag(call, f"{what} from pageable host memory (the host "
                             f"waits for the stream, non_blocking or not)")
        elif src == PINNED and not _true(_keyword(call, "non_blocking")):
            self._flag(call, f"{what} from the host without "
                             f"`non_blocking=True`")

    def _scan_repeat(self, call: ast.Call, d: Optional[str],
                     recv: Optional[str]) -> None:
        if _keyword(call, "output_size") is not None:
            return
        if d is not None and d.startswith("torch."):
            repeats = call.args[1] if len(call.args) > 1 else (
                call.args[0] if call.args else _keyword(call, "repeats"))
        elif recv in (HOST, PINNED):
            return
        else:
            repeats = call.args[0] if call.args else _keyword(call,
                                                              "repeats")
        if repeats is not None and not isinstance(repeats, ast.Constant):
            self._flag(call, "`repeat_interleave` with tensor repeats and "
                             "no `output_size` (its size is read back)")

    # ---------------------------------------------------------- tracking
    def _bind(self, target: ast.AST, value: Optional[ast.AST]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, value)
            return
        if isinstance(target, ast.Starred):
            target = target.value
        text = dotted(target)
        if text is None:
            return
        k = self.kind_of(value) if value is not None else None
        if k is None:
            self.kind.pop(text, None)
        else:
            self.kind[text] = k
        if value is not None and self._is_mask(value):
            self.masks.add(text)
        else:
            self.masks.discard(text)

    # ------------------------------------------------------------ the walk
    def walk(self) -> List[Finding]:
        self._walk_body(self.fn.body)
        return self.findings

    def _walk_body(self, body) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.If, ast.While)):
            if isinstance(stmt, ast.If) and _timed_gated(stmt.test):
                self._walk_body(stmt.orelse)   # gated body is exempt
                return
            self._scan_expr(stmt.test)
            self._truth(stmt.test)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            self._bind(stmt.target, None)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for h in stmt.handlers:
                self._walk_body(h.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)
            self._walk_body(stmt.body)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return          # nested defs are designated separately
        # flat statement: scan for syncs, then update the tracking
        self._scan_expr(stmt)
        if isinstance(stmt, ast.Assert):
            self._truth(stmt.test)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._bind(t, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, stmt.value)


@register(RULE, "hot-path functions sync the card once, deliberately")
def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ctx.functions():
        if ctx.directives.is_hotpath_def(fn.lineno):
            findings.extend(_HotWalker(ctx, fn).walk())
    return findings

"""The port's static checker (``repro_torch.analysis.staticcheck``) against
the reference's: the engine (directives, suppressions, baseline,
fingerprints, parse errors, refcount on the restore fixtures) finding for
finding on the same buffers; each reference rule's cases beside their
torch counterparts; the probe of torch hazards the reference cannot see;
the CLI; and the gate: the port scans clean."""
import json
import os
import textwrap
from pathlib import Path

import pytest

from repro.analysis.staticcheck import core as ref_core
from repro_torch.analysis.staticcheck import core
from repro_torch.analysis.staticcheck.cli import main as cli_main

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
PROBE = FIXTURES / "staticcheck_torch" / "sync_probe.py"


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.context)


def _both(src, select=None, path="buf.py"):
    """(reference findings, port findings) of one buffer; the port reads
    it with the directive prefix rewritten."""
    src = textwrap.dedent(src)
    ref = ref_core.check_source(src, path, select)
    port = core.check_source(src.replace("staticcheck: disable",
                                         "torchcheck: disable"), path, select)
    return ref, port


# ------------------------------------------------------------ engine parity
LEAK = """
    def admit(self, sess, need):
        got = self.allocator.alloc(need){trailing}
        if got is None:
            return False
        if sess.cancelled:
            return False
        sess.pages = got
        return True
"""

# name -> (buffer, the rule that reads it, findings of the reference)
ENGINE_BUFFERS = {
    "finding": (LEAK.format(trailing=""), "refcount-pairing", 1),
    "trailing-suppression": (LEAK.format(
        trailing="  # staticcheck: disable=refcount-pairing -- handed on"),
        "refcount-pairing", 0),
    "standalone-suppression": (LEAK.replace(
        "        got = self.allocator",
        "        # staticcheck: disable=refcount-pairing -- handed on\n"
        "        got = self.allocator").format(trailing=""),
        "refcount-pairing", 0),
    "unused-suppression": ("""
        def quiet():
            # staticcheck: disable=refcount-pairing -- nothing here
            return 1
    """, "refcount-pairing", 1),
    "suppression-of-all": (LEAK.format(
        trailing="  # staticcheck: disable=all -- every rule"),
        "refcount-pairing", 0),
    "unjustified-suppression": (LEAK.format(
        trailing="  # staticcheck: disable=refcount-pairing"),
        "refcount-pairing", 0),
    "parse-error": ("def broken(:\n", "refcount-pairing", 1),
    "hot-item-tolist": ("""
        def tick(self):  # staticcheck: hotpath
            v = self.model.logits()
            return v.item(), v.tolist()
    """, "hot-sync", 2),
    "retain-raise": ("""
        def share(self, pages):
            self.allocator.retain(pages)
            if not self.ok():
                raise RuntimeError("bad")
            self.table.append(pages)
    """, "refcount-pairing", 1),
}


@pytest.mark.parametrize("name", sorted(ENGINE_BUFFERS))
@pytest.mark.parametrize("selected", [False, True])
def test_engine_parity(name, selected):
    src, rule, n = ENGINE_BUFFERS[name]
    ref, port = _both(src, [rule] if selected else None)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    assert [f.fingerprint() for f in port] == [f.fingerprint() for f in ref]
    assert len(ref) == n


@pytest.mark.parametrize("fixture,n", [("*restore_leak.py", 1),
                                       ("*restore_fixed.py", 0)])
def test_engine_parity_refcount_fixtures(fixture, n):
    path, = (FIXTURES / "staticcheck").glob(fixture)
    src = path.read_text()
    ref, port = _both(src, ["refcount-pairing"], str(path))
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    assert len(port) == n
    if n:
        leak_line = next(i + 1 for i, ln in enumerate(src.splitlines())
                         if "LEAK LINE" in ln)
        assert port[0].line == leak_line
        assert port[0].context == "Admitter.try_admit_tiered"


def test_fingerprints_ignore_line_numbers():
    src = textwrap.dedent(ENGINE_BUFFERS["hot-item-tolist"][0])
    prints = []
    for check in (ref_core.check_source, core.check_source):
        a = check(src, "buf.py")
        b = check("\n\n\n" + src, "buf.py")
        assert len(a) == 2 and [f.line + 3 for f in a] == [f.line for f in b]
        assert [f.fingerprint() for f in a] == [f.fingerprint() for f in b]
        prints.append([f.fingerprint() for f in a])
    assert prints[0] == prints[1]


@pytest.mark.parametrize("justified", [True, False])
def test_baseline_parity(tmp_path, justified):
    out = []
    for mod in (ref_core, core):
        src = textwrap.dedent(LEAK.format(trailing=""))
        findings = mod.check_source(src, "buf.py")
        path = str(tmp_path / f"{mod.__name__}.json")
        empty = mod.write_baseline(path, findings, {})
        assert empty == len(findings) == 1
        if justified:
            data = json.loads(Path(path).read_text())
            data["entries"][0]["justification"] = "handed to the caller"
            Path(path).write_text(json.dumps(data))
        new, old, stale, unjust = mod.apply_baseline(
            mod.check_source(src, "buf.py"), mod.load_baseline(path))
        out.append(([_key(f) for f in new], [_key(f) for f in old], stale,
                    [e["fingerprint"] for e in unjust]))
    assert out[0] == out[1]
    assert len(out[1][1]) == 1 and bool(out[1][3]) is not justified


def test_directive_prefixes():
    """The port honours only ``torchcheck: disable``; it reads the
    reference's ``hotpath`` marker; a standalone directive aims past the
    reference's directive stacked below it."""
    src = textwrap.dedent("""
        def tick(self):  # staticcheck: hotpath
            v = self.model.logits()
            # torchcheck: disable=hot-sync -- the one sync
            # staticcheck: disable=hot-sync -- the one sync
            a = v.item()
            b = v.item()  # staticcheck: disable=hot-sync -- not the port's
            return a, b
    """)
    port = core.check_source(src, "buf.py", ["hot-sync"])
    assert [(f.rule, f.line) for f in port] == [("hot-sync", 7)]
    suppressed = []
    core.check_source(src, "buf.py", ["hot-sync"], suppressed=suppressed)
    assert [(f.line, s.comment_line, s.justification)
            for f, s in suppressed] == [(6, 4, "the one sync")]
    ref = ref_core.check_source(src, "buf.py", ["hot-sync"])
    assert ref == []                  # both of its directives are used


def test_hot_functions_lists_the_markers(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("class A:\n    # torchcheck: hotpath\n    def f(self):\n"
                 "        pass\n\n    # staticcheck: hotpath\n"
                 "    # a note\n    def g(self):\n        pass\n\n"
                 "    def h(self):\n        pass\n")
    got = core.hot_functions([str(p)])
    assert [(q, line) for _, q, line in got] == [("A.f", 3), ("A.g", 8)]


# ------------------------------------------------------------- rule parity
def _marked(src):
    """Source and the lines marked ``# <-`` (expected findings)."""
    src = textwrap.dedent(src)
    return src, [i + 1 for i, ln in enumerate(src.splitlines())
                 if ln.rstrip().endswith("# <-")]


HOT = "def tick(self, timed=False):  # staticcheck: hotpath\n"
# (id, reference rule, reference source | None, port rule, port source)
RULE_CASES = [
    # ---- hot-sync
    ("int-pos", "hot-sync", HOT + """
        x = jnp.ones((4,))
        return int(jnp.argmax(x))  # <-
    """, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        return int(torch.argmax(x))  # <-
    """),
    ("int-neg-shape", "hot-sync", HOT + """
        toks = np.zeros((4, 1), np.int32)
        return int(toks[0, 0])
    """, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        return int(x.shape[0])
    """),
    ("float-bool-pos", "hot-sync", HOT + """
        x = jnp.ones(())
        return float(x), bool(x)  # <-
    """, "hot-sync", HOT + """
        x = torch.ones((), device="cuda")
        return float(x), bool(x > 0)  # <-
    """),
    ("scalar-neg-host-tensor", None, None, "hot-sync", HOT + """
        x = torch.from_numpy(np.ones(4))
        return int(x[0]), float(x[1])
    """),
    ("asarray-pos", "hot-sync", HOT + """
        logits = jnp.ones((4, 8))
        return np.asarray(logits)  # <-
    """, "hot-sync", HOT + """
        logits = torch.ones((4, 8), device="cuda")
        return np.asarray(logits)  # <-
    """),
    ("asarray-neg-converted", "hot-sync", HOT + """
        # staticcheck: disable=hot-sync -- the one sync
        nxt = np.asarray(jnp.ones((4,)))
        return int(nxt[0])
    """, "hot-sync", HOT + """
        # torchcheck: disable=hot-sync -- the one sync
        nxt = np.asarray(torch.ones(4, device="cuda").cpu())
        return int(nxt[0]), np.array(nxt)
    """),
    ("item-pos", "hot-sync", HOT + """
        x = jnp.ones(())
        return x.item()  # <-
    """, "hot-sync", HOT + """
        x = torch.ones((), device="cuda")
        return x.item()  # <-
    """),
    ("tolist-pos", "hot-sync", HOT + """
        return self.out.tolist()  # <-
    """, "hot-sync", HOT + """
        return self.out.tolist()  # <-
    """),
    ("item-tolist-neg-host", None, None, "hot-sync", HOT + """
        a = np.zeros(4)
        return a.tolist(), a[0].item()
    """),
    ("cpu-numpy-pos", "hot-sync", HOT + """
        x = jnp.ones(4)
        return jax.device_get(x)  # <-
    """, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        a = x.cpu()  # <-
        return x.numpy()  # <-
    """),
    ("cpu-neg-host", "hot-sync", HOT + """
        x = np.ones(4)
        return x
    """, "hot-sync", HOT + """
        h = torch.from_numpy(np.ones(4))
        return h.cpu(), h.numpy()
    """),
    ("to-cpu-pos", None, None, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        return x.to("cpu")  # <-
    """),
    ("to-cpu-neg", None, None, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        return x.to("cpu", non_blocking=True), x.to(torch.float16)
    """),
    ("sync-calls-pos", "hot-sync", HOT + """
        x = jnp.ones(4)
        jax.block_until_ready(x)  # <-
        return x.block_until_ready()  # <-
    """, "hot-sync", HOT + """
        torch.cuda.synchronize()  # <-
        self.stream.synchronize()  # <-
        self.done.synchronize()  # <-
        self._sync()  # <-
    """),
    ("sync-calls-neg-timed", "hot-sync", HOT + """
        x = jnp.ones(())
        if timed:
            jax.block_until_ready(x)
        return x
    """, "hot-sync", HOT + """
        x = torch.ones((), device="cuda")
        if timed:
            torch.cuda.synchronize()
            self._sync()
        self._sync_device()
        return x
    """),
    ("implicit-bool-pos", None, None, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        if (x > 0).any():  # <-
            x = x + 1
        while x.sum() > 0:  # <-
            x = x - 1
        y = not (x[0] > 0)  # <-
        z = (x[0] > 0) and (x[1] > 0)  # <-
        w = 1 if x[0] else 2  # <-
        assert x.all()  # <-
        return [v for v in range(3) if x[v]]  # <-
    """),
    ("implicit-bool-neg", None, None, "hot-sync", HOT + """
        x = torch.ones(4, device="cuda")
        if x is not None and x.dim() == 1:
            x = x + 1
        if self.paged or x.shape[0] > 1:
            x = x * 2
        return x
    """),
    ("data-dependent-pos", None, None, "hot-sync", HOT + """
        x = torch.ones(8, device="cuda")
        a = x.nonzero()  # <-
        b = torch.nonzero(x)  # <-
        c = torch.where(x > 0)  # <-
        d = torch.masked_select(x, x > 0)  # <-
        e = torch.unique(x)  # <-
        f = x.argwhere()  # <-
        m = x > 0
        g = x[m]  # <-
        h = x[~m & (x < 4)]  # <-
        r = torch.repeat_interleave(x[:4], self.reps)  # <-
        return a, b, c, d, e, f, g, h, r
    """),
    ("data-dependent-neg", None, None, "hot-sync", HOT + """
        x = torch.ones(8, device="cuda")
        a = torch.where(x > 0, x, 0.0)
        b = x[self.idx]
        c = x[2:4]
        d = np.nonzero(np.ones(4))
        e = torch.repeat_interleave(x[:4], self.reps, output_size=8)
        f = x[:4].repeat_interleave(2)
        return a, b, c, d, e, f
    """),
    ("upload-pos", None, None, "hot-sync", HOT + """
        host = torch.from_numpy(np.arange(4))
        pinned = host.pin_memory()
        self.dst.copy_(host)  # <-
        self.dst.copy_(pinned)  # <-
        a = host.to(self.device)  # <-
        b = host.to(self.device, non_blocking=True)  # <-
        c = torch.tensor([1, 2], device=self.device)  # <-
        logits = self._run_step(torch.from_numpy(self.toks))  # <-
        return a, b, c, logits
    """),
    ("upload-neg", None, None, "hot-sync", HOT + """
        pinned = torch.zeros(4, pin_memory=True)
        self.dst.copy_(pinned, non_blocking=True)
        a = pinned.to(self.device, non_blocking=True)
        b = self.dst.to(self.device)
        self.dst.copy_(self.src)
        c = torch.from_numpy(np.arange(4)).to(torch.float32)
        logits = self._run_step(pinned_copy(self.toks, self.device))
        return a, b, c, logits
    """),
    ("annotated-param-pos", "hot-sync", """
        def tick(self, logits):  # staticcheck: hotpath
            return int(logits[0])  # <-
    """, "hot-sync", """
        def tick(self, logits: torch.Tensor):  # staticcheck: hotpath
            return int(logits[0])  # <-
    """),
    ("unmarked-neg", "hot-sync", """
        def tick(self):
            return int(jnp.argmax(jnp.ones(4)))
    """, "hot-sync", """
        def tick(self):
            return int(torch.argmax(torch.ones(4, device="cuda")))
    """),
    # ---- capture-hazard (reference: recompile-hazard)
    ("build-in-loop-pos", "recompile-hazard", """
        def build(fns):
            out = []
            for f in fns:
                out.append(jax.jit(f))  # <-
            listed = [jax.jit(f) for f in fns]  # <-
            return out, listed
    """, "capture-hazard", """
        def build(fns, program):
            out = []
            for f in fns:
                out.append(torch.cuda.CUDAGraph())  # <-
                with torch.cuda.graph(self.g):  # <-
                    f()
            caps = [capture(f, {}) for f in fns]  # <-
            runs = [program.executor(m) for m in ("full_jit",)]  # <-
            comp = {f: torch.compile(f) for f in fns}  # <-
            return out, caps, runs, comp
    """),
    ("build-once-neg", "recompile-hazard", """
        step = jax.jit(lambda x: x)

        def drive(xs):
            return [step(x) for x in xs]
    """, "capture-hazard", """
        def drive(program, xs, f):
            run = program.executor("full_jit")
            g = torch.cuda.CUDAGraph()
            cap = capture(f, {})
            comp = torch.compile(f)
            return [run(x) for x in xs], g, cap, comp
    """),
    ("immediate-pos", "recompile-hazard", """
        def call(f, x):
            return jax.jit(f)(x)  # <-
    """, "capture-hazard", """
        def call(f, x, program):
            a = torch.compile(f)(x)  # <-
            return a, program.executor("full_jit")(x)  # <-
    """),
    ("literal-pos", "recompile-hazard", """
        step = jax.jit(lambda x, n: x * n)

        def drive(x):
            return step(x, 3)  # <-
    """, "capture-hazard", """
        step = torch.compile(lambda x, n: x * n)

        def drive(x):
            return step(x, 3), step(x, n=(1, 2))  # <-
    """),
    ("literal-neg", "recompile-hazard", """
        step = jax.jit(lambda x, n: x * n, static_argnums=(1,))

        def drive(x):
            return step(x, 3)
    """, "capture-hazard", """
        step = torch.compile(lambda x, n: x * n)

        def drive(x, n_t):
            return step(x, n_t), other(x, 3)
    """),
    # ---- graph-output-alias (reference: donation-safety)
    ("read-after-next-call-pos", "donation-safety", """
        step = jax.jit(lambda p, c, t: (t, c), donate_argnums=(1,))

        def drive(p, cache, tok):
            logits, new_cache = step(p, cache, tok)  # <-
            return logits, cache.shape
    """, "graph-output-alias", """
        def drive(program, state):
            run = program.executor("full_jit")
            first = run(state)["logits"]  # <-
            run(state)
            return first.argmax()
    """),
    ("rebound-neg", "donation-safety", """
        step = jax.jit(lambda p, c, t: (t, c), donate_argnums=(1,))

        def drive(p, cache, tok):
            logits, cache = step(p, cache, tok)
            return logits, cache.shape
    """, "graph-output-alias", """
        def drive(program, state):
            run = program.executor("full_jit")
            logits = run(state)["logits"]
            logits = run(state)["logits"]
            return logits.argmax()
    """),
    ("loop-pos", "donation-safety", """
        step = jax.jit(lambda p, c, t: (t, c), donate_argnums=(1,))

        def drive(p, cache, toks):
            outs = []
            for t in toks:
                outs.append(step(p, cache, t))  # <-
            return outs
    """, "graph-output-alias", """
        def drive(program, states):
            run = program.executor("full_jit")
            outs = []
            for s in states:
                logits = run(s)["logits"]  # <-
                outs.append(logits)
            return torch.stack(outs)
    """),
    ("loop-clone-neg", "donation-safety", """
        step = jax.jit(lambda p, c, t: (t, c), donate_argnums=(1,))

        def drive(p, cache, toks):
            for t in toks:
                out, cache = step(p, cache, t)
            return cache
    """, "graph-output-alias", """
        def drive(program, states):
            run = program.executor("full_jit")
            outs = []
            for s in states:
                logits = run(s)["logits"]
                outs.append(logits.clone())
                tok = logits.argmax(-1)
            return torch.stack(outs), tok
    """),
    ("registry-pos", "donation-safety", """
        def tick(self, toks):
            logits, cache = self._progs.step(self.params, self.cache, toks)  # <-
            return logits, self.cache["pos"]
    """, "graph-output-alias", """
        def tick(self, toks):
            logits, self.cache = self._progs.step(self.params, self.cache, toks)  # <-
            self._progs.step(self.params, self.cache, toks)
            return logits[:, -1]
    """),
    ("registry-neg", None, None, "graph-output-alias", """
        def tick(self, toks):
            logits, self.cache = self._progs.step(self.params, self.cache, toks)
            nxt = self._sample(logits[:, -1])
            self._progs.step(self.params, self.cache, toks)
            return nxt
    """),
    ("output-across-replay-pos", None, None, "graph-output-alias", """
        def replay_all(cap, xs):
            outs = {}
            for i, x in enumerate(xs):
                cap.replay()
                outs[i] = {k: v for k, v in cap.output.items()}  # <-
            return outs
    """),
    ("output-clone-neg", None, None, "graph-output-alias", """
        def __call__(self, state, batch):
            self._cap.replay()
            return self._state, {k: v.clone() for k, v in self._cap.output.items()}

        def replay_all(cap, xs):
            outs = []
            for x in xs:
                cap.replay()
                outs.append({k: v.clone() for k, v in cap.output.items()})
            return outs
    """),
    ("train-step-neg", None, None, "graph-output-alias", """
        def run(step, state, batches):
            jstep = jit_train_step(step)
            metrics = []
            for b in batches:
                state, m = jstep(state, b)
                metrics.append(m)
            return state, metrics
    """),
    # ---- generator-discipline (reference: prng-discipline)
    ("same-stream-pos", "prng-discipline", """
        def gen(seed):
            key = jax.random.PRNGKey(seed)
            a = jax.random.normal(key, (4,))
            b = jax.random.normal(key, (4,))  # <-
            return a, b
    """, "generator-discipline", """
        def gen(seed):
            g1 = torch.Generator(device="cuda").manual_seed(seed)
            g2 = torch.Generator(device="cuda").manual_seed(seed)  # <-
            return g1, g2
    """),
    ("derived-neg", "prng-discipline", """
        def gen(seed):
            key = jax.random.PRNGKey(seed)
            a = jax.random.normal(key, (4,))
            key = jax.random.fold_in(key, 1)
            b = jax.random.normal(key, (4,))
            return a, b
    """, "generator-discipline", """
        def gen(seed, other):
            g1 = torch.Generator().manual_seed(seed)
            g2 = torch.Generator().manual_seed(seed + 1)
            seed = other
            g3 = torch.Generator().manual_seed(seed)
            return g1, g2, g3
    """),
    ("loop-pos", "prng-discipline", """
        def gen(key, n):
            outs = []
            for i in range(n):
                outs.append(jax.random.normal(key, (4,)))  # <-
            return outs
    """, "generator-discipline", """
        def gen(seed, n):
            outs = []
            for i in range(n):
                g = torch.Generator()  # <-
                outs.append(g.manual_seed(seed))  # <-
            return outs
    """),
    ("loop-neg", "prng-discipline", """
        def init(key):
            ks = jax.random.split(key, 3)
            return [jax.random.normal(ks[i], (4,)) for i in range(3)]
    """, "generator-discipline", """
        def gen(seed, n):
            g = torch.Generator()
            outs = []
            for i in range(n):
                outs.append(torch.randn(4, generator=g.manual_seed(seed + i)))
            return outs
    """),
    ("branches-neg", "prng-discipline", """
        def gen(key, arith):
            if arith:
                x = jax.random.randint(key, (4,), 0, 10)
            else:
                x = jax.random.normal(key, (4,))
            return x
    """, "generator-discipline", """
        def gen(seed, on_card):
            if on_card:
                g = torch.Generator(device="cuda").manual_seed(seed)
            else:
                g = torch.Generator().manual_seed(seed)
            return g
    """),
    ("hot-draw-pos", None, None, "generator-discipline", HOT + """
        x = torch.rand(4, device="cuda")  # <-
        y = torch.randint(0, 9, (4,))  # <-
        x.exponential_()  # <-
        z = torch.multinomial(x, 1)  # <-
        g = torch.Generator(device="cuda")  # <-
        return x, y, z, g
    """),
    ("hot-draw-neg", None, None, "generator-discipline", HOT + """
        x = torch.rand(4, device="cuda", generator=self.gen)
        x.exponential_(generator=self.gen)
        z = torch.multinomial(x, 1, generator=self.gen)
        return x, z, torch.empty_like(x)

        def cold(self):
            return torch.rand(4)
    """),
    # ---- refcount-pairing (the same rule in both)
    ("refcount-pos", "refcount-pairing", """
        def admit(self, sess, need):
            got = self.allocator.alloc(need)  # <-
            if got is None:
                return False
            if sess.cancelled:
                return False
            sess.pages = got
            return True
    """, "refcount-pairing", """
        def admit(self, sess, need):
            got = self.allocator.alloc(need)  # <-
            if got is None:
                return False
            if sess.cancelled:
                return False
            sess.pages = got
            return True
    """),
    ("refcount-neg", "refcount-pairing", """
        def admit(self, sess, need):
            got = self.allocator.alloc(need)
            if got is None:
                return False
            if sess.cancelled:
                self.allocator.release(got)
                return False
            sess.pages = got
            return True
    """, "refcount-pairing", """
        def grab(self, need):
            got = self._alloc_or_preempt(need, None)
            if got:
                self.holds.append(got)

        def hand_out(self, need):
            got = self.allocator.alloc_free(need)
            return got
    """),
]


@pytest.mark.parametrize("case", RULE_CASES, ids=[
    f"{c[3]}:{c[0]}" for c in RULE_CASES])
def test_rule_parity(case):
    _, ref_rule, ref_src, rule, src = case
    if ref_src is not None:
        text, want = _marked(ref_src)
        got = ref_core.check_source(text, "ref.py", [ref_rule])
        assert sorted({f.line for f in got}) == want, [f.render() for f in got]
    text, want = _marked(src)
    got = core.check_source(text, "port.py", [rule])
    assert sorted({f.line for f in got}) == want, [f.render() for f in got]
    assert {f.rule for f in got} <= {rule}


def test_every_rule_has_paired_cases():
    rules = {c[3] for c in RULE_CASES}
    assert rules == {"hot-sync", "capture-hazard", "graph-output-alias",
                     "generator-discipline", "refcount-pairing"}
    assert rules == set(core.RULES)
    for rule in rules:
        cases = [c for c in RULE_CASES if c[3] == rule]
        assert any("# <-" in c[4] for c in cases)
        assert any("# <-" not in c[4] for c in cases)
        assert any(c[2] is not None for c in cases)


# ----------------------------------------------------------------- the probe
def test_probe_reference_sees_nothing_port_one_finding_a_form():
    src = PROBE.read_text()
    want = sorted((i + 1, ln.split("# expect: ")[1].strip())
                  for i, ln in enumerate(src.splitlines())
                  if "# expect: " in ln)
    assert len(want) == 9
    assert ref_core.check_source(src, str(PROBE)) == []
    got = core.check_source(src, str(PROBE))
    assert sorted((f.line, f.rule) for f in got) == want


def test_cli_on_probe_and_clean_file(tmp_path, capsys):
    report = tmp_path / "report.json"
    none = str(tmp_path / "none.json")
    assert cli_main([str(PROBE), "--json", str(report), "--baseline", none]) == 1
    blob = json.loads(report.read_text())
    assert blob["files_scanned"] == 1 and len(blob["new"]) == 9
    assert blob["rules"] == sorted(core.RULES)
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli_main([str(good), "--baseline", none]) == 0
    assert cli_main([]) == 2
    assert cli_main([str(good), "--select", "no-such-rule"]) == 2
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "graph-output-alias" in out and "hot-sync" in out


def test_cli_baseline_needs_a_justification(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n\ndef call(f, x):\n"
                   "    return torch.compile(f)(x)\n")
    baseline = str(tmp_path / "baseline.json")
    assert cli_main([str(bad), "--baseline", baseline, "--write-baseline"]) == 1
    assert cli_main([str(bad), "--baseline", baseline]) == 1
    data = json.loads(Path(baseline).read_text())
    data["entries"][0]["justification"] = "bench-only; traced once"
    Path(baseline).write_text(json.dumps(data))
    assert cli_main([str(bad), "--baseline", baseline]) == 0
    out = capsys.readouterr()
    assert "1 baselined" in out.err + out.out


# ------------------------------------------------------------- the repo gate
def test_port_is_clean_under_its_checker():
    port = ROOT / "src" / "repro_torch"
    findings, n_files = core.run_paths([str(port)])
    assert n_files > 50
    assert findings == [], [f.render() for f in findings]


def test_port_hot_paths_and_deliberate_syncs():
    """Every hot path the reference's markers name is read by the port's
    checker, and every deliberate sync it suppresses is justified."""
    port = str(ROOT / "src" / "repro_torch")
    hot = {q for _, q, _ in core.hot_functions([port])}
    assert {"Model.decode_step", "Model.decode_steps",
            "_GraphExecutor.__call__", "DecodeEngine.generate_streamed",
            "SlotScheduler._decode_tick_single", "SlotScheduler._run_step",
            "SlotScheduler._decode_tick_horizon", "_GraphStep.__call__",
            "PageStore.sync"} <= hot
    suppressed = []
    core.run_paths([port], suppressed=suppressed)
    assert suppressed and all(s.justification for _, s in suppressed)
    assert {f.context for f, _ in suppressed if f.rule == "hot-sync"} == {
        "DecodeEngine.generate_streamed", "SlotScheduler._decode_tick_single",
        "SlotScheduler._decode_tick_horizon"}


def test_fixture_dir_is_outside_src():
    assert not str(PROBE).startswith(str(ROOT / "src"))
    assert os.path.isfile(PROBE)

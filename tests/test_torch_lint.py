"""repro_torch.analysis.lint on the CPU: each rule on distilled fixtures,
the port's rules held to the reference's, and the port-wide gates.

The six rules carried over from ``repro.analysis.lint`` (id-dtype,
ops-ref-parity, state-mutation, pow2-pad, event-determinism,
event-trace-site) give the reference's ``(rule, line)`` verdicts on the
reference's fixtures (``tests/test_lint.py``) and on every file of
``src/repro``, with the reference's ref path and dispatcher table passed
in; over ``src/repro_torch`` the port's rules find at least what the
reference's find, before allows.  The two rewritten rules have fixtures of
their own: ``host-sync`` on eager torch (and the line it reports is the
line CPython reports while the call runs, which is what the card's sync
debug mode names), ``ctypes-sig`` on a fixture ``.cu`` text.  Gates: the
port lints clean with no baseline, the baseline is empty, the CLI's exit
codes, and the lint importing no torch, jax or repro.
"""
import ast
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from repro.analysis import lint as RL
from repro.analysis.rules import ALL_RULES as REF_RULES
from repro.analysis.rules import pow2_pad as ref_pow2_pad
from repro_torch.analysis import astutil
from repro_torch.analysis import lint as L
from repro_torch.analysis.rules import (ALL_RULES, ctypes_sig, host_sync,
                                        id_dtype, ops_ref, pow2_pad,
                                        state_mut, trace_site)

REPO = Path(__file__).resolve().parents[1]
REF_SRC = REPO / "src/repro"
PORT_SRC = REPO / "src/repro_torch"


def _ctx(src, rel="src/repro_torch/core/fake.py", project=None, path=None):
    src = textwrap.dedent(src)
    return L.FileCtx(Path(path or rel), rel, src, project or L.Project())


def _rules(src, rule, **kw):
    ctx = _ctx(src, **kw)
    return ctx, L.apply_allows(ctx, rule.check(ctx))


def _verdicts(violations):
    return sorted((v.rule, v.line) for v in violations)


# ---------------------------------------------------------------------------
# The six carried rules on the reference's fixtures (tests/test_lint.py)
# ---------------------------------------------------------------------------

# (rule id, source, repo-relative path, violations expected there)
REF_FIXTURES = {
    "frombuffer": ("id-dtype", """
        import numpy as np

        def unpack(buf):
            return np.frombuffer(buf)   # an int64 view of an int32 log
    """, "src/repro/core/fake.py", 1),
    "int64_ids": ("id-dtype", """
        import numpy as np

        def build(n_items, ccs, sids):
            cc_arr = np.asarray(ccs, np.int64)          # id: flagged
            flat = np.fromiter(sids, np.int64)          # id data: flagged
            versions = np.zeros((n_items,), np.int64)   # payload: fine
            vals = np.asarray([1.0], np.float64)        # fine
            return cc_arr, flat, versions, vals
    """, "src/repro/core/fake.py", 2),
    "foreign_writes": ("state-mutation", """
        def grow(self, store, lm):
            store.versions = store.versions + 1
            lm.qlen[0] = 3
            self.blocked = True          # plain attr, not a subscript cell
    """, "src/repro/core/fake.py", 2),
    "owner_file": ("state-mutation", """
        def grow(self, store, lm):
            store.versions = store.versions + 1
            lm.qlen[0] = 3
            self.blocked = True          # plain attr, not a subscript cell
    """, "src/repro/core/lease.py", 0),
    "tuple_targets": ("state-mutation", """
        def swap(self):
            self.store.values, self.store.versions = 1, 2
    """, "src/repro/core/fake.py", 2),
    "raw_len_alloc": ("pow2-pad", """
        import numpy as np
        from repro.kernels.ops import settle_lease_batch

        def bad(groups):
            wait_req = np.zeros((len(groups), 4), np.int32)
            return settle_lease_batch(1, 2, 3, 4, 5, wait_req, 7, 8)

        def good(groups, _pad_bucket):
            b = _pad_bucket(len(groups))
            wait_req = np.zeros((b, 4), np.int32)
            return settle_lease_batch(1, 2, 3, 4, 5, wait_req, 7, 8)
    """, "src/repro/core/fake.py", 1),
    "wall_clock": ("event-determinism", """
        import time

        def on_deliver(self):
            t = time.time()
            self.events.schedule(t, lambda: None)
    """, "src/repro/core/fake.py", 1),
    "wall_clock_outside_core": ("event-determinism", """
        import time

        def on_deliver(self):
            t = time.time()
            self.events.schedule(t, lambda: None)
    """, "src/repro/analysis/bench.py", 0),
    "set_iteration": ("event-determinism", """
        def recheck(self, nodes):
            pending = set(nodes)
            for n in pending:                  # hash order drives dispatch
                self.events.schedule(0.0, lambda: None)
            for n in sorted(pending):          # deterministic: fine
                self.events.schedule(0.0, lambda: None)
            for n in pending:                  # no scheduling inside: fine
                self.count += 1
    """, "src/repro/core/fake.py", 1),
    "id_ordering": ("event-determinism", """
        def order(self, lors, seen):
            worst = sorted(lors, key=id)       # address order: flagged
            if id(lors[0]) < id(lors[1]):      # address compare: flagged
                pass
            return [l for l in lors if id(l) in seen]   # membership: fine
    """, "src/repro/core/fake.py", 2),
    "computed_event_names": ("event-trace-site", """
        def f(self, node, kind):
            tr = self.trace
            if tr is not None:
                tr.instant(f"dispatch-{kind}", "events", ts=1.0)
                tr.span("exec" if kind else "x", "t", 0.0, 1.0)
                self.trace.counter(kind, "t", 0.0, 1)
    """, "src/repro/core/fake.py", 3),
    "literal_event_names": ("event-trace-site", """
        def f(self, node, txid):
            tr = self.trace
            if tr is not None:
                tr.instant("forward", f"node{node}/dtd", ts=1.0, txid=txid)
                tr.span("exec", f"node{node}/t0", 0.0, 1.0)
            self.stats.counter(txid)        # not a trace receiver
            span = make_span(txid)          # bare name, not a method call
    """, "src/repro/core/fake.py", 0),
}

CARRIED = ("id-dtype", "ops-ref-parity", "state-mutation", "pow2-pad",
           "event-determinism", "event-trace-site")


def _by_id(rules):
    return {r.id: r for r in rules}


def _ref_side_port_rules():
    """The port's carried rules with the reference's own tables passed in:
    its ref path (ops-ref-parity) and its jit'd dispatchers (pow2-pad)."""
    rules = _by_id(ALL_RULES)
    rules["ops-ref-parity"] = ops_ref.Rule("src/repro/kernels/ref.py")
    rules["pow2-pad"] = pow2_pad.Rule(ref_pow2_pad.DISPATCHERS)
    return rules


@pytest.mark.parametrize("name", sorted(REF_FIXTURES))
def test_carried_rule_matches_reference_on_its_fixture(name):
    rule_id, src, rel, n = REF_FIXTURES[name]
    port = _ref_side_port_rules()[rule_id]
    ref = _by_id(REF_RULES)[rule_id]
    src = textwrap.dedent(src)
    got = port.check(L.FileCtx(Path(rel), rel, src, L.Project()))
    want = ref.check(RL.FileCtx(Path(rel), rel, src, RL.Project()))
    assert len(got) == n
    assert _verdicts(got) == _verdicts(want)


def test_event_trace_site_holds_region_names_to_literals():
    """The model path's profiler ranges keep the recorder's contract:
    ``region`` bare or on the regions module with a computed name is a
    violation; a literal is not, nor another function or receiver."""
    src = """
        from repro_torch.obs import regions
        from repro_torch.obs.regions import region

        def f(x, kind):
            with region("repro.ok"):
                pass
            with regions.region("repro.ok", device=x.device):
                pass
            with region(f"repro.{kind}"):          # flagged
                pass
            with regions.region(kind):             # flagged
                pass
            with region(name="repro." + kind):     # flagged
                pass
            comm.region_input(x, kind)             # another function
            helper.region(kind)                    # not a trace receiver
    """
    _, vs = _rules(src, trace_site.RULE)
    assert _verdicts(vs) == [("event-trace-site", n) for n in (10, 12, 14)]


class _FakeProject(L.Project):
    def __init__(self, ref_src, tests_src):
        super().__init__()
        self._ref = ref_src
        self._tests_src = tests_src

    def read_text(self, rel):
        return self._ref if rel.endswith("ref.py") else None

    def tests_text(self):
        return self._tests_src


def test_ops_ref_requires_twin_and_named_test():
    ops_src = """
        from . import ref

        def covered(x):
            return ref.covered_ref(x)

        def untested(x):
            return ref.untested_ref(x)

        def twinless(x):
            return x
    """
    ref_src = ("def covered_ref(x):\n    return x\n\n"
               "def untested_ref(x):\n    return x\n")
    proj = _FakeProject(ref_src, "def test_covered():\n    covered(1)\n")
    _, vs = _rules(ops_src, ops_ref.RULE,
                   rel="src/repro_torch/kernels/ops.py", project=proj)
    msgs = "\n".join(v.msg for v in vs)
    assert "covered" not in msgs.replace("untested", "")
    assert "untested" in msgs and "twinless" in msgs


def test_ops_ref_reads_the_ports_twins():
    """``certify_drain``'s twin is the port's ``ref.lease_drain_ref``: the
    reference's rule, reading ``src/repro/kernels/ref.py``, misses it."""
    rel = "src/repro_torch/kernels/ops.py"
    src = (REPO / rel).read_text()
    assert ops_ref.RULE.check(L.FileCtx(REPO / rel, rel, src,
                                        L.Project())) == []
    ref_rule = _by_id(REF_RULES)["ops-ref-parity"]
    got = ref_rule.check(RL.FileCtx(REPO / rel, rel, src, RL.Project()))
    assert [v.msg.split("'")[1] for v in got] == ["certify_drain"]


@pytest.mark.parametrize("rule_id", CARRIED)
def test_carried_rule_matches_reference_on_every_reference_file(rule_id):
    port = _ref_side_port_rules()[rule_id]
    ref = _by_id(REF_RULES)[rule_id]
    n_files = 0
    for path in sorted(REF_SRC.rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        src = path.read_text()
        got = port.check(L.FileCtx(path, rel, src, L.Project()))
        want = ref.check(RL.FileCtx(path, rel, src, RL.Project()))
        assert _verdicts(got) == _verdicts(want), rel
        n_files += 1
    assert n_files > 50


class _PortRefProject(RL.Project):
    """The reference's rules reading the port's twins where they would
    read the reference's."""

    def read_text(self, rel):
        return super().read_text(rel.replace("src/repro/", "src/repro_torch/"))


def test_port_rules_find_what_the_reference_rules_find_over_the_port():
    """Before allows: every (file, rule, line) a reference rule finds in
    ``src/repro_torch`` a port rule finds too (the reference's host-sync
    and static-args find nothing there: the port has no jit)."""
    port_rules, ref_rules = ALL_RULES, REF_RULES
    missing = []
    for path in sorted(PORT_SRC.rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        src = path.read_text()
        got = Counter((v.rule, v.line) for r in port_rules
                      for v in r.check(L.FileCtx(path, rel, src,
                                                 L.Project())))
        want = Counter((v.rule, v.line) for r in ref_rules
                       for v in r.check(RL.FileCtx(path, rel, src,
                                                   _PortRefProject())))
        missing += [f"{rel}:{line} [{rule}]"
                    for (rule, line), n in want.items()
                    if got[(rule, line)] < n]
    assert missing == []


def test_state_mutation_allow_restored_in_scenarios():
    """The seeded mutant's out-of-band write carries its reason, as in the
    reference."""
    rel = "src/repro_torch/analysis/scenarios.py"
    ctx = L.FileCtx(REPO / rel, rel, (REPO / rel).read_text(), L.Project())
    raw = state_mut.RULE.check(ctx)
    assert [v.msg for v in raw] == [
        "mutation of protected protocol state '._by_req' outside its "
        "owning module"]
    assert L.apply_allows(ctx, raw) == []


# ---------------------------------------------------------------------------
# id-dtype on torch
# ---------------------------------------------------------------------------

def test_id_dtype_flags_torch_int64_ids():
    _, vs = _rules("""
        import torch

        def build(n, ccs, buf):
            cc_t = torch.zeros(n, dtype=torch.long)        # flagged
            owners = torch.as_tensor(ccs, dtype=torch.int64)   # flagged
            wide = ccs.long()                              # flagged
            cast = ccs.to(torch.int64)                     # flagged
            ok = ccs.to(torch.int32)                       # fine
            counts = torch.zeros(n, dtype=torch.int64)     # payload: fine
            view = torch.frombuffer(buf)                   # no dtype
            return cc_t, owners, wide, cast, ok, counts, view
    """, id_dtype.RULE)
    assert len(vs) == 5
    assert [v.msg.split()[0] for v in vs if "frombuffer" in v.msg] == [
        "torch.frombuffer"]
    assert sorted(v.msg.split("'")[1] for v in vs
                  if "frombuffer" not in v.msg) == [
        "cc_t", "ccs", "ccs", "owners"]


# ---------------------------------------------------------------------------
# host-sync (eager torch)
# ---------------------------------------------------------------------------

def _host_sync(src, rel="src/repro_torch/models/fake.py"):
    return _rules(src, host_sync.RULE, rel=rel)[1]


def test_host_sync_tolist_in_models_body_flagged_in_launch_quiet():
    src = """
        import torch

        def route(x, n):
            counts = torch.bincount(x.reshape(-1), minlength=n).tolist()
            return counts
    """
    vs = _host_sync(src)
    assert len(vs) == 2 and all(v.rule == "host-sync" for v in vs)
    assert {v.msg.split()[0] for v in vs} == {".tolist()", "bincount()"}
    assert _host_sync(src, rel="src/repro_torch/launch/fake.py") == []


def test_host_sync_allow_comment_needs_reason():
    ok = """
        import torch

        def route(x):
            # lint: allow(host-sync): the routed path needs the counts
            return x.sum().item()
    """
    assert _host_sync(ok) == []
    bad = ok.replace(": the routed path needs the counts", "")
    vs = _host_sync(bad)
    assert len(vs) == 1 and "lacks a reason" in vs[0].msg


def test_host_sync_flags_waits_and_leaves_host_values():
    vs = _host_sync("""
        import numpy as np
        import torch

        def step(logits: torch.Tensor, tokens: np.ndarray, dev, stream):
            t = torch.from_numpy(tokens).to(dev)            # copy in: flagged
            t2 = torch.from_numpy(tokens).to(dev, non_blocking=True)
            c0 = torch.tensor(0.5, dtype=logits.dtype, device=dev)  # flagged
            c1 = torch.full((), 0.5, dtype=logits.dtype, device=dev)
            n = float(logits.sum())                         # flagged
            s = float(logits.shape[0]) + int(len(tokens))
            w = int(tokens[0]) + tokens.tolist()[0]          # host: fine
            nxt = logits.argmax(-1).cpu().numpy()           # flagged once
            hit = torch.nonzero(logits > 0)                  # flagged
            u = np.unique(tokens)                            # numpy: fine
            r = logits.repeat_interleave(2, dim=0)           # int: fine
            rr = logits.repeat_interleave(t)                 # flagged
            ro = logits.repeat_interleave(t, output_size=8)  # fine
            stream.synchronize()                             # flagged
            torch.cuda.synchronize()                         # flagged
            back = logits.to("cpu")                          # flagged
            half = logits.to(torch.float16)                  # dtype: fine
            return t, t2, c0, c1, n, s, w, nxt, hit, u, r, rr, ro, back, half
    """)
    lines = sorted(v.line for v in vs)
    assert len(vs) == 9, "\n".join(v.render() for v in vs)
    assert len(set(lines)) == 9


def test_host_sync_scope_device_paths_only_outside_models():
    """In serve/ and the core modules only the functions that name torch
    are hot; kernels/nvcc.py is the build."""
    src = """
        import torch

        def host_side(self, sid):
            return int(self.store.versions[sid]) + self.rows.tolist()[0]

        def device_side(self, x: torch.Tensor):
            return x.tolist()
    """
    for rel in ("src/repro_torch/serve/fake.py",
                "src/repro_torch/core/stm.py",
                "src/repro_torch/core/lease_batched.py"):
        vs = _host_sync(src, rel=rel)
        assert [v.msg.split("'")[-2] for v in vs] == ["device_side"], rel
    assert len(_host_sync(src, rel="src/repro_torch/models/fake.py")) == 2
    for rel in ("src/repro_torch/kernels/nvcc.py",
                "src/repro_torch/core/cluster.py",
                "src/repro_torch/launch/serve.py"):
        assert _host_sync(src, rel=rel) == []


class _Probe:
    """Stands in for a tensor: records the line CPython reports for the
    caller's frame at each call, as the sync debug mode's warning does."""

    def __init__(self, seen):
        self.seen = seen

    def _at(self, *args, **kw):
        self.seen.append(sys._getframe(1).f_lineno)
        return self

    item = tolist = cpu = numpy = sum = argmax = _at


def test_host_sync_reports_the_line_cpython_runs():
    """A chain split over lines reports the line of the flagged attribute,
    the line a frame shows while the call runs."""
    src = textwrap.dedent("""
        def f(x: "torch.Tensor"):
            a = (x
                 .sum()
                 .cpu())
            b = x.argmax(
                -1).tolist()
            c = (x.sum()
                 .item())
            return a, b, c
    """)
    vs = host_sync.RULE.check(L.FileCtx(Path("f.py"),
                                        "src/repro_torch/models/f.py", src,
                                        L.Project()))
    seen = []
    ns = {}
    exec(compile(src, "f.py", "exec"), ns)
    ns["f"](_Probe(seen))
    # the probe sees sum, cpu, argmax, tolist, sum, item in that order
    assert sorted(v.line for v in vs) == [seen[1], seen[3], seen[5]]
    assert astutil.call_line(ast.parse("x.y()").body[0].value) == 1


# ---------------------------------------------------------------------------
# ctypes-sig
# ---------------------------------------------------------------------------

CU = """
// a launcher and a helper
extern "C" int toy_launch(const void* x, void* out, int n,
                          long long bytes, int* chosen, void* stream) {
  return 0;
}
extern "C" int toy_alloc(long long bytes, int device, void** host) {
  return 0;
}
"""

TABLE = '''
import ctypes
from .nvcc import CudaLibrary

_P = ctypes.c_void_p
LIB = CudaLibrary("toy", {
    "toy_launch": (
        [_P] * 2 + [ctypes.c_int, ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_int), _P], ctypes.c_int),
    "toy_alloc": (
        [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)],
        ctypes.c_int),
})
'''


def _ctypes(tmp_path, table, cu=CU):
    (tmp_path / "csrc").mkdir(exist_ok=True)
    (tmp_path / "csrc" / "toy.cu").write_text(cu)
    py = tmp_path / "toy.py"
    py.write_text(table)
    ctx = L.FileCtx(py, "src/repro_torch/kernels/toy.py", table,
                    L.Project())
    return ctypes_sig.RULE.check(ctx)


def test_ctypes_sig_quiet_on_a_matching_table(tmp_path):
    assert _ctypes(tmp_path, TABLE) == []


@pytest.mark.parametrize("mutant,expect", [
    # one argument dropped
    (("[_P] * 2 + [ctypes.c_int, ctypes.c_longlong",
      "[_P] * 2 + [ctypes.c_longlong"), "5 argtypes"),
    # c_int where the C side takes long long
    (("[_P] * 2 + [ctypes.c_int, ctypes.c_longlong",
      "[_P] * 2 + [ctypes.c_int, ctypes.c_int"), "takes long long"),
    # an opaque pointer declared as POINTER(c_void_p)
    (("ctypes.POINTER(ctypes.c_void_p)]", "ctypes.c_void_p]"),
     "takes void**"),
    # the return type
    (("ctypes.POINTER(ctypes.c_void_p)],\n        ctypes.c_int",
      "ctypes.POINTER(ctypes.c_void_p)],\n        ctypes.c_longlong"),
     "restype"),
    # a name with no extern "C" function
    (('"toy_alloc": (', '"toy_allocate": ('), "no extern"),
])
def test_ctypes_sig_flags_a_mutated_table(tmp_path, mutant, expect):
    old, new = mutant
    assert old in TABLE
    vs = _ctypes(tmp_path, TABLE.replace(old, new))
    assert len(vs) == 1 and expect in vs[0].msg, [v.msg for v in vs]


def test_ctypes_sig_reads_the_three_libraries():
    """The launchers of csrc/*.cu with their arities, and their tables
    clean."""
    csrc = PORT_SRC / "kernels/csrc"
    arity = {name: len(sig[1]) for cu in sorted(csrc.glob("*.cu"))
             for name, sig in ctypes_sig.c_signatures(cu.read_text()).items()}
    assert arity == {
        "flash_attention_variant": 9, "flash_attention_launch": 23,
        "flash_attention_backward_variant": 9,
        "flash_attention_backward_launch": 28,
        "ssd_scan_backward_variant": 8, "ssd_scan_backward_launch": 26,
        "lease_validate_launch": 11, "lease_staging_alloc": 3,
        "lease_staging_free": 1, "lease_drain_launch": 8,
        "lease_drain_empty": 1, "lease_validate_empty": 1,
        "ssd_scan_variant": 9, "ssd_scan_launch": 21,
        "ssd_tc_state_launch": 14,
        "ssd_tc_chunk_launch": 12}
    for name in ("flash_attention", "lease_validate", "ssd_scan"):
        path = PORT_SRC / f"kernels/{name}.py"
        rel = path.relative_to(REPO).as_posix()
        ctx = L.FileCtx(path, rel, path.read_text(), L.Project())
        assert "CudaLibrary(" in ctx.src
        assert ctypes_sig.RULE.check(ctx) == []


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def test_port_lints_clean_with_no_baseline():
    violations = L.lint_paths([L.DEFAULT_TARGET])
    assert violations == [], "\n".join(v.render() for v in violations)


def test_committed_baseline_is_empty():
    assert L.DEFAULT_BASELINE.exists()
    assert L.load_baseline(L.DEFAULT_BASELINE) == set()


def test_cli_runs_clean_and_strict_mode_fails_on_injected(tmp_path, capsys):
    assert L.main([]) == 0
    assert L.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    ids = [line.split(":")[0] for line in listed if ":" in line]
    assert len(ids) == 8 and {"host-sync", "ctypes-sig"} <= set(ids)
    bad = tmp_path / "src/repro_torch/models/bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n\n\ndef f(x):\n    return x.item()\n")
    assert L.main([str(bad), "--no-baseline"]) == 1


def test_lint_is_a_pinned_copy_of_the_reference():
    """The framework is the reference's, but for its paths and names."""
    want = (REF_SRC / "analysis/lint.py").read_text()
    for old, new in (('SRC_ROOT / "repro"', 'SRC_ROOT / "repro_torch"'),
                     ("# repro.analysis.lint baseline",
                      "# repro_torch.analysis.lint baseline"),
                     ('prog="repro-lint"', 'prog="repro-torch-lint"')):
        assert old in want
        want = want.replace(old, new)

    def body(text):
        tree = ast.parse(text)
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    got = (PORT_SRC / "analysis/lint.py").read_text()
    assert body(got) == body(want)


def test_lint_runs_without_torch_jax_or_repro():
    code = ("import sys\n"
            "from repro_torch.analysis import lint\n"
            "rc = lint.main(['--no-baseline'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'numpy', 'repro'))\n"
            "print(rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []"

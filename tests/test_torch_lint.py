"""galaxylint for the port (`galaxysql_tpu_torch/devtools/`) and its lockdep witness.

Mirrors `tests/test_lint.py` on port paths: every rule with positive and negative
fixtures (the jit-discipline rules on the port's counterparts: device expression
compiles outside a `closure_cache` builder, kernel-library calls outside the
launch-counting `kernels/cuda_*.py` wrappers, `.item()` and
`torch.cuda.synchronize()` on the hot path), the pragma and baseline suppression
round trips, stale entries, the whole-tree self-run and the CLI exiting 0, and the
lockdep witness (`galaxysql_tpu_torch/utils/lockdep.py`) with the seeded inversion
on the port's insert ramp.  A parity test runs the same fixture sources, with the
package prefix renamed, through both packages' lock-order, typed-error and hygiene
checkers and holds the findings equal.
"""

import threading

import pytest

from galaxysql_tpu.devtools import lint as JL
from galaxysql_tpu.devtools.checkers.hygiene import HygieneChecker as JHygiene
from galaxysql_tpu.devtools.checkers.lock_order import LockOrderChecker as JLockOrder
from galaxysql_tpu.devtools.checkers.typed_errors import TypedErrorChecker as JTyped
from galaxysql_tpu_torch.devtools import lint as L
from galaxysql_tpu_torch.devtools.checkers import ALL_CHECKERS
from galaxysql_tpu_torch.devtools.checkers.hygiene import HygieneChecker
from galaxysql_tpu_torch.devtools.checkers.lock_order import LockOrderChecker
from galaxysql_tpu_torch.devtools.checkers.typed_errors import TypedErrorChecker
from galaxysql_tpu_torch.utils import lockdep
from galaxysql_tpu_torch.utils.failpoint import FAIL_POINTS, FP_LOCK_INVERT

pytestmark = pytest.mark.torch_port

PKG = "galaxysql_tpu_torch"


def rules_of(findings, suppressed=False):
    return sorted({f.rule for f in findings
                   if bool(f.suppressed) == suppressed})


# -- lock-order / lock-blocking ------------------------------------------------

LOCK_FIXTURES = {
    "inversion": ("def f(store, p):\n"
                  "    with p.lock:\n"
                  "        with store.append_lock:\n"
                  "            pass\n", "storage/x.py"),
    "canonical_with_metadb_io": ("def f(store, p, metadb):\n"
                                 "    with store.append_lock, p.lock:\n"
                                 "        metadb.kv_put('k', 'v')\n"
                                 "    with p.lock:\n"
                                 "        pass\n", "storage/x.py"),
    "multi_item_inversion": ("def f(store, p):\n"
                             "    with p.lock, store.append_lock:\n"
                             "        pass\n", "txn/x.py"),
    "one_level_call": ("def helper(self):\n"
                       "    with self.append_lock:\n"
                       "        pass\n"
                       "class MetaDb:\n"
                       "    def g(self):\n"
                       "        with self._lock:\n"
                       "            self.helper()\n", "meta/x.py"),
    "two_same_class": ("def f(p, part):\n"
                       "    with p.lock:\n"
                       "        with part.lock:\n"
                       "            pass\n", "storage/x.py"),
    "reentrant_same_expr": ("class Partition:\n"
                            "    def f(self):\n"
                            "        with self.lock:\n"
                            "            with self.lock:\n"
                            "                pass\n", "storage/x.py"),
    "blocking_under_hot_lock": ("import time\n"
                                "def f(store, client, metadb):\n"
                                "    with store.append_lock:\n"
                                "        time.sleep(0.1)\n"
                                "        client.request({})\n"
                                "        metadb.execute('x')\n"
                                "    time.sleep(0.1)\n", "server/x.py"),
    "out_of_scope_dir": ("def f(store, p):\n"
                         "    with p.lock:\n"
                         "        with store.append_lock:\n"
                         "            pass\n", "plan/x.py"),
}


def _lint(case, fixtures, **kw):
    src, rel = fixtures[case]
    return L.lint_source(src, f"{PKG}/{rel}", **kw)


class TestLockOrderRule:
    def test_inversion_flagged(self):
        assert rules_of(_lint("inversion", LOCK_FIXTURES)) == ["lock-order"]

    def test_canonical_order_clean(self):
        # the metadb IO under the partition lock is a lock-blocking warn, but the
        # ORDER is canonical: no lock-order finding
        assert "lock-order" not in rules_of(_lint("canonical_with_metadb_io",
                                                  LOCK_FIXTURES))

    def test_multi_item_with_orders_left_to_right(self):
        assert rules_of(_lint("multi_item_inversion", LOCK_FIXTURES)) == ["lock-order"]

    def test_one_level_call_propagation(self):
        fs = _lint("one_level_call", LOCK_FIXTURES)
        assert any(f.rule == "lock-order" and "via call to helper" in f.message
                   for f in fs)

    def test_two_same_class_locks_flagged(self):
        fs = _lint("two_same_class", LOCK_FIXTURES)
        assert any(f.rule == "lock-order" and "intra-class" in f.message for f in fs)

    def test_reentrant_same_expr_clean(self):
        assert rules_of(_lint("reentrant_same_expr", LOCK_FIXTURES)) == []

    def test_blocking_ops_under_hot_lock(self):
        blocking = [f for f in _lint("blocking_under_hot_lock", LOCK_FIXTURES)
                    if f.rule == "lock-blocking"]
        assert len(blocking) == 3
        assert all(f.line in (4, 5, 6) for f in blocking)

    def test_out_of_scope_dir_ignored(self):
        fs = _lint("out_of_scope_dir", LOCK_FIXTURES)
        assert [f for f in fs if f.rule.startswith("lock-")] == []


# -- jit-raw / pallas-raw / jit-device-sync on the port's counterparts -----------

class TestJitRules:
    def test_device_compile_outside_a_builder_flagged(self):
        fs = L.lint_source(
            "def f(device, e):\n"
            "    return ExprCompiler(TorchXP(device)).compile(e)\n"
            "def g(xp, e):\n"
            "    comp = ExprCompiler(xp)\n"
            "    return comp.compile(e)\n",
            f"{PKG}/exec/x.py")
        assert [f.rule for f in fs] == ["jit-raw", "jit-raw"]

    def test_device_compile_in_a_builder_clean(self):
        fs = L.lint_source(
            "def op(key, device, e):\n"
            "    def build():\n"
            "        comp = ExprCompiler(TorchXP(device))\n"
            "        return comp.compile(e)\n"
            "    return closure_cache(key, build)\n"
            "def op2(key, device, e):\n"
            "    return closure_cache(key, lambda: ExprCompiler(TorchXP(device))"
            ".compile(e))\n",
            f"{PKG}/exec/x.py")
        assert rules_of(fs) == []

    def test_numpy_compile_is_the_host_engine(self):
        fs = L.lint_source(
            "import numpy as np\n"
            "def f(e):\n"
            "    return ExprCompiler(np).compile(e)\n",
            f"{PKG}/exec/x.py")
        assert rules_of(fs) == []

    def test_kernel_library_call_outside_a_wrapper_flagged(self):
        fs = L.lint_source(
            "from galaxysql_tpu_torch.kernels import cuda_build as cb\n"
            "def f(t):\n"
            "    return cb.function('hash_place.cu', 'gx_hash_place', [])(t)\n"
            "def g():\n"
            "    return cb.library('join_slots.cu')\n",
            f"{PKG}/exec/x.py")
        assert [f.rule for f in fs] == ["pallas-raw", "pallas-raw"]

    def test_wrapper_that_counts_its_launch_clean(self):
        src = ("import ctypes\n"
               "from galaxysql_tpu_torch.kernels import cuda_build as cb\n"
               "LAUNCHES = {'k': 0}\n"
               "def k(t):\n"
               "    rc = cb.function('k.cu', 'gx_k', [])(cb.ptr(t))\n"
               "    cb.check(rc, 'k')\n"
               "    LAUNCHES['k'] += 1\n")
        assert rules_of(L.lint_source(src, f"{PKG}/kernels/cuda_k.py")) == []
        # the same call outside a kernels/cuda_*.py wrapper is flagged
        assert rules_of(L.lint_source(src, f"{PKG}/kernels/relational.py")) == \
            ["pallas-raw"]

    def test_wrapper_that_does_not_count_flagged(self):
        fs = L.lint_source(
            "from galaxysql_tpu_torch.kernels import cuda_build\n"
            "def k(t):\n"
            "    return cuda_build.function('k.cu', 'gx_k', [])(t)\n",
            f"{PKG}/kernels/cuda_k.py")
        assert rules_of(fs) == ["pallas-raw"]

    def test_host_library_build_is_not_a_kernel(self):
        fs = L.lint_source(
            "import ctypes\n"
            "from galaxysql_tpu_torch.kernels import cuda_build\n"
            "def load(src):\n"
            "    return ctypes.CDLL(cuda_build.build_host(src, 'g++', []))\n",
            f"{PKG}/native/__init__.py")
        assert rules_of(fs) == []

    def test_device_sync_in_hot_dir_flagged(self):
        fs = L.lint_source(
            "import torch\n"
            "def drain(v):\n"
            "    return v.item()\n"
            "def wait():\n"
            "    torch.cuda.synchronize()\n",
            f"{PKG}/exec/x.py")
        assert len([f for f in fs if f.rule == "jit-device-sync"]) == 2

    def test_profiling_scope_allowlisted(self):
        fs = L.lint_source(
            "import torch\n"
            "def profile_drain(v):\n"
            "    return v.item()\n"
            "class Bench:\n"
            "    def run(self, v):\n"
            "        torch.cuda.synchronize()\n"
            "        return v.item()\n",
            f"{PKG}/exec/x.py")
        assert rules_of(fs) == []

    def test_cold_dir_ignored(self):
        fs = L.lint_source(
            "def f(v):\n"
            "    return v.item()\n",
            f"{PKG}/meta/x.py")
        assert rules_of(fs) == []


# -- swallow / untyped-raise ---------------------------------------------------

TYPED_FIXTURES = {
    "silent_swallows": ("def f():\n"
                        "    try:\n"
                        "        g()\n"
                        "    except Exception:\n"
                        "        pass\n"
                        "def h():\n"
                        "    for i in x:\n"
                        "        try:\n"
                        "            g()\n"
                        "        except Exception:\n"
                        "            continue\n", "net/x.py"),
    "handled_swallows": ("def a():\n"
                         "    try:\n"
                         "        g()\n"
                         "    except Exception:\n"
                         "        raise errors.TddlError('x')\n"
                         "def b():\n"
                         "    try:\n"
                         "        g()\n"
                         "    except Exception as e:\n"
                         "        events.publish('boom', str(e))\n"
                         "def c(out):\n"
                         "    try:\n"
                         "        g()\n"
                         "    except Exception as e:\n"
                         "        out['err'] = e\n", "net/x.py"),
    "untyped_on_ramp": ("def f():\n"
                        "    raise ValueError('boom')\n", "server/x.py"),
    "untyped_off_ramp": ("def f():\n"
                         "    raise ValueError('boom')\n", "expr/x.py"),
    "typed_raise": ("def f():\n"
                    "    raise errors.QueryTimeoutError('deadline')\n", "server/x.py"),
}


class TestTypedErrorRules:
    def test_silent_swallow_flagged(self):
        fs = _lint("silent_swallows", TYPED_FIXTURES)
        assert len([f for f in fs if f.rule == "swallow"]) == 2

    def test_handled_swallows_clean(self):
        assert rules_of(_lint("handled_swallows", TYPED_FIXTURES,
                              test_text="boom")) == []

    def test_untyped_raise_flagged_on_ramp_only(self):
        assert rules_of(_lint("untyped_on_ramp", TYPED_FIXTURES)) == ["untyped-raise"]
        assert rules_of(_lint("untyped_off_ramp", TYPED_FIXTURES)) == []

    def test_typed_raise_clean(self):
        assert rules_of(_lint("typed_raise", TYPED_FIXTURES)) == []


# -- hygiene (cross-file) ------------------------------------------------------

# name: ([(relpath under the package, source)], test text)
HYGIENE_PROJECTS = {
    "dead_failpoint": ([("utils/fp.py", 'FP_NEVER = "FP_NEVER"\n')], ""),
    "armed_failpoint": ([("utils/fp.py", 'FP_USED = "FP_USED"\n')],
                        "FAIL_POINTS.arm(FP_USED)\n"),
    "failpoint_prefix": ([("utils/fp.py", 'FP_RPC_DELAY = "FP_RPC_DELAY"\n')],
                         "FAIL_POINTS.arm(FP_RPC_DELAY_MS, 5)\n"),
    "metric_orphans": ([("utils/m.py", "DEAD = Counter('dead', 'never updated')\n"
                                       "HIDDEN = Counter('hidden', 'never adopted')\n"
                                       "GOOD = Counter('good', 'updated and adopted')\n"
                                       "HIDDEN.inc()\n"
                                       "GOOD.inc()\n"),
                        ("server/i.py", "def boot(reg):\n"
                                        "    reg.adopt(DEAD)\n"
                                        "    reg.adopt(GOOD)\n")], ""),
    "histogram_unsampled": ([("utils/m.py", "H = Histogram('lat_ms', 'latency')\n"
                                            "H.observe(1)\n"),
                             ("server/i.py", "def boot(reg):\n"
                                             "    reg.adopt(H)\n")], ""),
}

EVENT_FIXTURES = {
    "uncorrelated_trigger": ("def trip(events, worker):\n"
                             "    events.publish('breaker_open', 'worker tripped',\n"
                             "                   worker=worker)\n", "server/x.py",
                             "breaker_open"),
    "correlated_trigger": ("def regress(events, d, tid):\n"
                           "    events.publish('plan_regression', 'plan got slower',\n"
                           "                   digest=d)\n"
                           "    events.publish('slo_burn', 'window burning',\n"
                           "                   trace_id=tid)\n", "server/x.py",
                           "plan_regression slo_burn"),
    "splat_unchecked": ("def fwd(events, kw):\n"
                        "    events.publish('columnar_tail_failed', 'tail', **kw)\n",
                        "server/x.py", "columnar_tail_failed"),
    "nontrigger_kind": ("def note(events):\n"
                        "    events.publish('gc_pause', 'background sweep')\n",
                        "server/x.py", "gc_pause"),
    "uncorrelated_pragma": ("def trip(events):\n"
                            "    events.publish('breaker_open', 'no query context')"
                            "  # galaxylint: disable=event-uncorrelated"
                            " -- background health loop, no statement to implicate\n",
                            "server/x.py", "breaker_open"),
    "untested_event": ("def note(events):\n"
                       "    events.publish('never_named', 'x')\n", "server/x.py", ""),
}


def _hygiene(case, lint_mod=L, checker=HygieneChecker, pkg=PKG):
    srcs, test_text = HYGIENE_PROJECTS[case]
    mods = [lint_mod.Module(f"{pkg}/{p}", s) for p, s in srcs]
    return list(checker().finalize(lint_mod.Project("", mods, test_text)))


def _event(case):
    src, rel, test_text = EVENT_FIXTURES[case]
    return L.lint_source(src, f"{PKG}/{rel}", test_text=test_text)


class TestHygieneRules:
    def test_dead_failpoint_flagged(self):
        assert [f.rule for f in _hygiene("dead_failpoint")] == ["dead-failpoint"]

    def test_armed_failpoint_clean(self):
        assert _hygiene("armed_failpoint") == []

    def test_failpoint_prefix_of_covered_key_still_dead(self):
        assert [f.rule for f in _hygiene("failpoint_prefix")] == ["dead-failpoint"]

    def test_metric_orphans(self):
        fs = _hygiene("metric_orphans")
        assert len(fs) == 2
        assert any("DEAD" in f.message and "never updated" in f.message for f in fs)
        assert any("HIDDEN" in f.message and "never adopted" in f.message for f in fs)
        assert all(f.rule == "metric-orphan" for f in fs)

    def test_unsampled_histogram_flagged(self):
        assert [f.rule for f in _hygiene("histogram_unsampled")] == \
            ["histogram-unsampled"]

    def test_uncorrelated_trigger_event_flagged(self):
        assert rules_of(_event("uncorrelated_trigger")) == ["event-uncorrelated"]

    def test_correlated_trigger_event_clean(self):
        assert "event-uncorrelated" not in rules_of(_event("correlated_trigger"))

    def test_trigger_event_splat_unchecked(self):
        assert "event-uncorrelated" not in rules_of(_event("splat_unchecked"))

    def test_nontrigger_kind_not_checked(self):
        assert "event-uncorrelated" not in rules_of(_event("nontrigger_kind"))

    def test_uncorrelated_pragma_suppresses(self):
        fs = _event("uncorrelated_pragma")
        assert "event-uncorrelated" not in rules_of(fs)
        assert "event-uncorrelated" in rules_of(fs, suppressed=True)

    def test_untested_event_flagged(self):
        assert rules_of(_event("untested_event")) == ["event-untested"]


# -- parity: the copied checkers against the reference's -------------------------

def _norm(findings):
    return sorted((f.rule, f.line, f.severity, f.message.replace(PKG, "galaxysql_tpu"),
                   f.qualname, f.line_text, f.suppressed) for f in findings)


PARITY_CASES = sorted([("lock", c) for c in LOCK_FIXTURES] +
                      [("typed", c) for c in TYPED_FIXTURES] +
                      [("event", c) for c in EVENT_FIXTURES])


@pytest.mark.parametrize("kind,case", PARITY_CASES)
def test_copied_checkers_find_what_the_reference_finds(kind, case):
    """The same fixture, under each package's prefix, through each package's
    lock-order, typed-error and hygiene checkers (pragmas applied): equal findings."""
    if kind == "lock":
        (src, rel), test_text = LOCK_FIXTURES[case], ""
    elif kind == "typed":
        (src, rel), test_text = TYPED_FIXTURES[case], "boom"
    else:
        src, rel, test_text = EVENT_FIXTURES[case]
    port = L.lint_source(src, f"{PKG}/{rel}", test_text=test_text,
                         checkers=[LockOrderChecker(), TypedErrorChecker(),
                                   HygieneChecker()])
    ref = JL.lint_source(src, f"galaxysql_tpu/{rel}", test_text=test_text,
                         checkers=[JLockOrder(), JTyped(), JHygiene()])
    assert _norm(port) == _norm(ref)
    for f in port:
        assert f.path == f"{PKG}/{rel}"


@pytest.mark.parametrize("case", sorted(HYGIENE_PROJECTS))
def test_hygiene_projects_find_what_the_reference_finds(case):
    port = _hygiene(case)
    ref = _hygiene(case, JL, JHygiene, "galaxysql_tpu")
    assert _norm(port) == _norm(ref)


# -- pragmas -------------------------------------------------------------------

class TestPragmas:
    SRC = ("def f(store, p):\n"
           "    with p.lock:\n"
           "        with store.append_lock:{pragma}\n"
           "            pass\n")
    PATH = f"{PKG}/storage/x.py"

    def test_justified_pragma_suppresses(self):
        fs = L.lint_source(self.SRC.format(
            pragma="  # galaxylint: disable=lock-order -- seeded inversion"), self.PATH)
        assert rules_of(fs) == []
        assert rules_of(fs, suppressed=True) == ["lock-order"]

    def test_unjustified_pragma_suppresses_nothing(self):
        fs = L.lint_source(self.SRC.format(
            pragma="  # galaxylint: disable=lock-order"), self.PATH)
        open_rules = rules_of(fs)
        assert "pragma-justify" in open_rules
        assert "lock-order" in open_rules

    def test_wrong_rule_pragma_does_not_suppress(self):
        fs = L.lint_source(self.SRC.format(
            pragma="  # galaxylint: disable=swallow -- wrong rule"), self.PATH)
        open_rules = rules_of(fs)
        assert "lock-order" in open_rules
        assert "pragma-unknown" in open_rules

    def test_stale_pragma_flagged(self):
        fs = L.lint_source(
            "def f():\n"
            "    x = 1  # galaxylint: disable=lock-ordr -- typo'd rule\n", self.PATH)
        assert rules_of(fs) == ["pragma-unknown"]

    def test_file_level_pragma(self):
        fs = L.lint_source(
            "# galaxylint: disable-file=lock-order -- fixture file\n" +
            self.SRC.format(pragma=""), self.PATH)
        assert rules_of(fs) == []

    def test_file_level_pragma_hygiene(self):
        fs = L.lint_source("# galaxylint: disable-file=swallow\nX = 1\n", self.PATH)
        assert "pragma-justify" in rules_of(fs)
        fs = L.lint_source("# galaxylint: disable-file=swallow -- nothing here\n"
                           "X = 1\n", self.PATH)
        assert rules_of(fs) == ["pragma-unknown"]


# -- baseline ------------------------------------------------------------------

class TestBaseline:
    def _findings(self):
        return _lint("silent_swallows", TYPED_FIXTURES)

    def test_round_trip_suppresses(self):
        fs = self._findings()
        entries = [{"rule": f.rule, "path": f.path, "qualname": f.qualname,
                    "line_text": f.line_text, "why": "grandfathered"} for f in fs]
        out = L.apply_baseline(self._findings(), entries)
        assert rules_of(out) == []
        assert rules_of(out, suppressed=True) == ["swallow"]

    def test_stale_entry_flagged(self):
        entries = [{"rule": "swallow", "path": f"{PKG}/net/x.py", "qualname": "gone",
                    "line_text": "except Exception:", "why": "was fixed"}]
        out = L.apply_baseline(self._findings(), entries)
        assert "baseline-stale" in rules_of(out)

    def test_unjustified_entry_suppresses_nothing(self):
        fs = self._findings()
        entries = [{"rule": f.rule, "path": f.path, "qualname": f.qualname,
                    "line_text": f.line_text, "why": ""} for f in fs]
        out = L.apply_baseline(self._findings(), entries)
        assert "swallow" in rules_of(out)
        assert "baseline-justify" in rules_of(out)

    def test_save_load_round_trip(self, tmp_path):
        path = str(tmp_path / "baseline.json")
        entries = [{"rule": "swallow", "path": "a.py", "qualname": "f",
                    "line_text": "except Exception:", "why": "because"}]
        L.save_baseline(path, entries)
        assert L.load_baseline(path) == entries

    def test_update_baseline_needs_a_why(self, tmp_path, capsys):
        path = str(tmp_path / "b.json")
        assert L.main(["--baseline", path, "--update-baseline"]) == 2
        assert "--why" in capsys.readouterr().err

    def test_stale_entry_in_the_committed_baseline_fails_the_run(self, tmp_path):
        """An entry that matches nothing makes the tree run fail."""
        path = str(tmp_path / "baseline.json")
        entries = L.load_baseline(L.BASELINE_PATH) + [
            {"rule": "swallow", "path": f"{PKG}/server/session.py",
             "qualname": "Session.gone", "line_text": "except Exception:",
             "why": "was fixed"}]
        L.save_baseline(path, entries)
        open_fs = [f for f in L.collect(baseline_path=path) if not f.suppressed]
        assert [f.rule for f in open_fs] == ["baseline-stale"]


# -- whole-tree self-run -------------------------------------------------------

class TestTreeClean:
    def test_walks_the_port(self):
        paths = {rel for rel, _src in L.iter_sources(L.find_root())}
        assert f"{PKG}/exec/operators.py" in paths
        assert all(p.startswith(f"{PKG}/") for p in paths)

    def test_zero_unsuppressed_findings(self):
        open_fs = [f for f in L.collect() if not f.suppressed]
        assert open_fs == [], "\n".join(f.render() for f in open_fs)

    def test_every_suppression_is_justified(self):
        entries = L.load_baseline(L.BASELINE_PATH)
        assert entries
        for e in entries:
            assert e.get("why"), f"unjustified baseline entry: {e}"

    def test_rules_registered(self):
        rules = {r for ck in ALL_CHECKERS for r in ck.rules}
        assert rules == {"lock-order", "lock-blocking", "jit-raw",
                         "pallas-raw", "jit-device-sync", "swallow",
                         "untyped-raise", "dead-failpoint", "metric-orphan",
                         "event-untested", "histogram-unsampled",
                         "event-uncorrelated"}

    def test_cli_exits_zero(self, capsys):
        assert L.main([]) == 0
        assert "0 finding(s)" in capsys.readouterr().out


# -- lockdep witness (runtime) -------------------------------------------------

@pytest.fixture()
def armed_lockdep():
    lockdep.enable()
    lockdep.WITNESS.reset()
    yield lockdep.WITNESS
    lockdep.disable()
    lockdep.WITNESS.reset()
    FAIL_POINTS.clear()


class TestLockdepUnit:
    def test_disarmed_returns_plain_lock(self):
        if not lockdep.enabled():
            lk = lockdep.named_lock("x")
            assert not hasattr(lk, "dep_name")

    def test_consistent_order_clean(self, armed_lockdep):
        a, b, c = (lockdep.named_lock(n) for n in ("la", "lb", "lc"))
        for _ in range(3):
            with a:
                with b:
                    with c:
                        pass
        armed_lockdep.assert_clean()
        assert ("la", "lb") in armed_lockdep.edges()

    def test_inversion_raises(self, armed_lockdep):
        a, b = lockdep.named_lock("ia"), lockdep.named_lock("ib")
        with a:
            with b:
                pass
        with pytest.raises(lockdep.LockOrderViolation, match="inverts"):
            with b:
                with a:
                    pass
        assert armed_lockdep.violations

    def test_three_lock_cycle(self, armed_lockdep):
        a, b, c = (lockdep.named_lock(n) for n in ("ca", "cb", "cc"))
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(lockdep.LockOrderViolation):
            with c:
                with a:
                    pass

    def test_reentrant_instance_ok(self, armed_lockdep):
        a = lockdep.named_lock("ra")
        with a:
            with a:
                pass
        armed_lockdep.assert_clean()

    def test_same_class_two_instances_raises(self, armed_lockdep):
        a1, a2 = lockdep.named_lock("pp"), lockdep.named_lock("pp")
        with pytest.raises(lockdep.LockOrderViolation, match="intra-class"):
            with a1:
                with a2:
                    pass

    def test_violation_does_not_wedge(self, armed_lockdep):
        a, b = lockdep.named_lock("wa"), lockdep.named_lock("wb")
        with a:
            with b:
                pass
        with pytest.raises(lockdep.LockOrderViolation):
            with b:
                with a:
                    pass
        done = []
        t = threading.Thread(target=lambda: (a.acquire(), a.release(),
                                             done.append(1)))
        t.start()
        t.join(5)
        assert not t.is_alive() and done == [1]


class TestLockdepSeeded:
    def test_seeded_inversion_caught_on_insert_ramp(self, armed_lockdep):
        """FP_LOCK_INVERT drives a partition -> append_lock acquisition on the
        port's insert ramp; the witness trips, and the disarmed statement passes."""
        from galaxysql_tpu_torch.server.instance import Instance
        from galaxysql_tpu_torch.server.session import Session
        s = Session(Instance(device="cpu"))
        try:
            s.execute("CREATE DATABASE ld")
            s.execute("USE ld")
            s.execute("CREATE TABLE t (a BIGINT, b BIGINT) "
                      "PARTITION BY HASH(a) PARTITIONS 2")
            s.execute("INSERT INTO t VALUES (1, 10)")
            armed_lockdep.assert_clean()
            assert any(a == "append_lock" and b.startswith("partition")
                       for a, b in armed_lockdep.edges())
            FAIL_POINTS.arm(FP_LOCK_INVERT, True)
            with pytest.raises(lockdep.LockOrderViolation):
                s.execute("INSERT INTO t VALUES (2, 20)")
            assert armed_lockdep.violations
            FAIL_POINTS.clear()
            armed_lockdep.violations.clear()
            s.execute("INSERT INTO t VALUES (3, 30)")
            assert s.execute("SELECT count(*) FROM t").rows[0][0] >= 2
            armed_lockdep.assert_clean()
        finally:
            s.close()

    def test_canonical_write_path_clean(self, armed_lockdep):
        """Inserts, an UPDATE and a DELETE on a table with a global index record
        only edges of the canonical order."""
        from galaxysql_tpu_torch.server.instance import Instance
        from galaxysql_tpu_torch.server.session import Session
        s = Session(Instance(device="cpu"))
        try:
            s.execute("CREATE DATABASE lw")
            s.execute("USE lw")
            s.execute("CREATE TABLE w (a BIGINT, b BIGINT) "
                      "PARTITION BY HASH(a) PARTITIONS 4")
            s.execute("CREATE GLOBAL INDEX gw ON w (b)")
            for i in range(8):
                s.execute(f"INSERT INTO w VALUES ({i}, {i * 10})")
            s.execute("UPDATE w SET b = 99 WHERE a = 3")
            s.execute("DELETE FROM w WHERE a = 5")
            assert s.execute("SELECT count(*) FROM w").rows == [(7,)]
            armed_lockdep.assert_clean()
        finally:
            s.close()

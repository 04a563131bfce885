"""dead-failpoint / metric-orphan: chaos + observability hygiene.

Cross-file passes (they run in `finalize`, over the whole project):

- **dead-failpoint**: an `FP_*` key defined in the package but never armed
  by any test is dead chaos coverage — the failure path it guards is never
  exercised, which is exactly how exactly-once/recovery bugs hide.  Tests
  count as coverage by NAME (symbol or string literal) anywhere under
  tests/.
- **metric-orphan**: a module-level process-shared metric constant
  (`NAME = Counter/Gauge/Histogram(...)`) must be BOTH updated somewhere
  (`.inc/.observe/.set/.dec` — otherwise it's a dead gauge lying on every
  dashboard) and surfaced (referenced by a module that adopts metrics into
  the instance registry — otherwise it's invisible to SHOW METRICS,
  information_schema.metrics, and Prometheus).  Registry-created metrics
  (`registry.counter(...)`) auto-surface and are exempt.
- **event-untested**: every typed journal event kind published anywhere in
  the package (a string-literal first argument to `publish(...)`) must be
  named by at least one test — an alert nobody has ever armed or asserted
  is an alert that silently rots (the SLO plane's slo_burn/metric_anomaly
  events are load-bearing precisely because tests drive them).
- **histogram-unsampled**: every process-shared histogram adopted into the
  registry must be named by a test so its expansion (`<name>_p99` etc.)
  provably appears in a metric-history sample — otherwise the SLO plane's
  windows can lose an input without any test noticing.
- **event-uncorrelated**: publish sites for flight-recorder TRIGGER kinds
  (slo_burn, plan_regression, breaker_open, admission_reject,
  columnar_tail_failed, metric_anomaly) must pass a correlation key —
  `trace_id=` or `digest=` — or carry a justified pragma: an incident
  bundle captured off an uncorrelated trigger cannot implicate the
  statement that caused it, so the recorder degrades to guesswork.
"""

from __future__ import annotations

import ast
import re
from typing import List

from galaxysql_tpu_torch.devtools.lint import Checker, Finding, Project

_FP_NAME = re.compile(r"^FP_[A-Z0-9_]+$")
_METRIC_CTORS = ("Counter", "Gauge", "Histogram")


class HygieneChecker(Checker):
    rules = ("dead-failpoint", "metric-orphan", "event-untested",
             "histogram-unsampled", "event-uncorrelated")
    description = ("FP_* keys never armed by any test; process-shared "
                   "metrics never updated or never adopted/surfaced; "
                   "journal event kinds / adopted histograms never "
                   "exercised by any test; trigger-kind events published "
                   "without a trace_id/digest correlation key")

    # event kinds the flight recorder treats as incident triggers
    # (server/flight_recorder.py EVENT_TRIGGERS + the reject-storm kind)
    TRIGGER_KINDS = frozenset({
        "slo_burn", "plan_regression", "breaker_open", "admission_reject",
        "columnar_tail_failed", "metric_anomaly"})

    def finalize(self, project: Project):
        findings: List[Finding] = []
        findings.extend(self._dead_failpoints(project))
        findings.extend(self._metric_orphans(project))
        findings.extend(self._untested_events(project))
        findings.extend(self._unsampled_histograms(project))
        findings.extend(self._uncorrelated_events(project))
        return findings

    def _dead_failpoints(self, project: Project):
        findings = []
        for mod in project.modules:
            for node in ast.iter_child_nodes(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and _FP_NAME.match(tgt.id) \
                            and isinstance(node.value, ast.Constant) \
                            and isinstance(node.value.value, str):
                        # word-boundary match: FP_RPC_DELAY must not count
                        # as covered because tests arm FP_RPC_DELAY_MS
                        if not re.search(rf"\b{tgt.id}\b",
                                         project.test_text):
                            findings.append(self.finding(
                                mod, node.lineno,
                                f"fail point {tgt.id} is never armed by any "
                                f"test: dead chaos coverage — the failure "
                                f"path it guards is never exercised",
                                rule="dead-failpoint"))
        return findings

    def _metric_orphans(self, project: Project):
        findings = []
        # modules that adopt process-shared metrics into a registry
        adopters = [m for m in project.modules if ".adopt(" in m.src]
        for mod in project.modules:
            for node in ast.iter_child_nodes(mod.tree):
                if not isinstance(node, ast.Assign) or \
                        not isinstance(node.value, ast.Call):
                    continue
                fn = node.value.func
                ctor = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else "")
                if ctor not in _METRIC_CTORS:
                    continue
                for tgt in node.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    name = tgt.id
                    updated = re.search(
                        rf"\b{name}\.(inc|observe|observe_many|set|dec)\b",
                        project.package_text)
                    if not updated:
                        findings.append(self.finding(
                            mod, node.lineno,
                            f"metric {name} is registered but never "
                            f"updated anywhere — a dead metric lying on "
                            f"every dashboard", rule="metric-orphan"))
                    surfaced = any(re.search(rf"\b{name}\b", a.src)
                                   for a in adopters if a is not mod) or \
                        re.search(rf"adopt\(\s*{name}\b", mod.src)
                    if not surfaced:
                        findings.append(self.finding(
                            mod, node.lineno,
                            f"process-shared metric {name} is never adopted "
                            f"into an instance registry — invisible to SHOW "
                            f"METRICS / information_schema.metrics / "
                            f"Prometheus", rule="metric-orphan"))
        return findings

    def _untested_events(self, project: Project):
        """Every string-literal kind passed to `publish(...)` anywhere in
        the package must appear (word-boundary) somewhere under tests/.
        Variable kinds can't be checked statically and are skipped."""
        findings = []
        seen = set()  # report each kind once, at its first publish site
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                fname = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else "")
                if fname != "publish":
                    continue
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    continue
                kind = arg.value
                if kind in seen:
                    continue
                seen.add(kind)
                if not re.search(rf"\b{re.escape(kind)}\b",
                                 project.test_text):
                    findings.append(self.finding(
                        mod, node.lineno,
                        f"journal event kind '{kind}' is published here but "
                        f"never named by any test — an alert nobody has "
                        f"armed or asserted silently rots",
                        rule="event-untested"))
        return findings

    def _uncorrelated_events(self, project: Project):
        """Every publish site whose string-literal kind is a flight-recorder
        TRIGGER must pass `trace_id=` or `digest=` (the incident bundle's
        implication keys).  Sites with genuinely no query context
        (background loops) carry a justified pragma instead.  Unlike
        event-untested this reports every SITE, not each kind once — each
        uncorrelated publish degrades a different trigger path."""
        findings = []
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                fname = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else "")
                if fname != "publish":
                    continue
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)) or \
                        arg.value not in self.TRIGGER_KINDS:
                    continue
                keys = {kw.arg for kw in node.keywords if kw.arg}
                has_splat = any(kw.arg is None for kw in node.keywords)
                if keys & {"trace_id", "digest"} or has_splat:
                    continue  # **kwargs splats can't be checked statically
                findings.append(self.finding(
                    mod, node.lineno,
                    f"trigger-kind event '{arg.value}' is published without "
                    f"a trace_id/digest correlation key — the flight "
                    f"recorder cannot implicate the statement behind this "
                    f"incident", rule="event-uncorrelated"))
        return findings

    def _unsampled_histograms(self, project: Project):
        """Every module-level `NAME = Histogram("metric", ...)` must have
        its METRIC NAME (the ctor's string argument, not the Python
        symbol) appear in tests/ — the SLO-plane suite asserts each one's
        `<name>_p99` expansion lands in a history sample."""
        findings = []
        for mod in project.modules:
            for node in ast.iter_child_nodes(mod.tree):
                if not isinstance(node, ast.Assign) or \
                        not isinstance(node.value, ast.Call):
                    continue
                fn = node.value.func
                ctor = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else "")
                if ctor != "Histogram" or not node.value.args:
                    continue
                arg = node.value.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    continue
                metric = arg.value
                if not re.search(rf"\b{re.escape(metric)}\b",
                                 project.test_text):
                    findings.append(self.finding(
                        mod, node.lineno,
                        f"histogram '{metric}' is never named by any test — "
                        f"nothing proves its quantile expansion reaches a "
                        f"metric-history sample",
                        rule="histogram-unsampled"))
        return findings

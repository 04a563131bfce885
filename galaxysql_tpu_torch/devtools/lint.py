"""galaxylint framework: pluggable AST checkers, pragmas, committed baseline.

Flow: walk the package tree (tests/ and __pycache__/ excluded), parse each
file once, run every registered checker (per-file `check` plus cross-file
`finalize`), then suppress findings through two mechanisms:

- **pragmas** — `# galaxylint: disable=<rule>[,rule...] -- <justification>`
  on the offending line (or `disable-file=` on any line of the file).  A
  pragma WITHOUT a justification suppresses nothing and is itself a finding,
  and a pragma naming a rule that never fires there is a `pragma-unknown`
  finding: suppressions must say why, and must suppress something real.
- **baseline** — `devtools/baseline.json`, the committed grandfather list.
  Entries key on (rule, path, enclosing qualname, stripped line text) so they
  survive line drift; every entry carries a one-line `why`.  An entry that no
  longer matches anything is a `baseline-stale` finding, so the baseline can
  only shrink.

Exit status 0 means zero unsuppressed findings — the `make lint` CI gate.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

PRAGMA_RE = re.compile(
    r"#\s*galaxylint:\s*(disable(?:-file)?)=([\w,\-]+)(?:\s*--\s*(\S.*))?")

SEVERITIES = ("error", "warn")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str            # repo-relative, e.g. galaxysql_tpu_torch/server/session.py
    line: int
    severity: str        # error | warn
    message: str
    qualname: str = ""   # enclosing Class.function scope
    line_text: str = ""  # stripped source line (the drift-stable baseline key)
    suppressed: str = "" # "" | "pragma" | "baseline"

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.qualname, self.line_text)

    def render(self) -> str:
        sup = f" [suppressed:{self.suppressed}]" if self.suppressed else ""
        where = f" ({self.qualname})" if self.qualname else ""
        return (f"{self.path}:{self.line}: [{self.severity}] {self.rule}: "
                f"{self.message}{where}{sup}")


class Module:
    """One parsed source file plus its pragma table and scope map."""

    def __init__(self, relpath: str, src: str):
        self.relpath = relpath
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src)
        # line -> (set(rules), justification or None)
        self.pragmas: Dict[int, Tuple[set, Optional[str]]] = {}
        self.file_pragmas: Dict[str, Optional[str]] = {}
        for i, text in enumerate(self.lines, 1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            kind, rules, why = m.group(1), m.group(2), m.group(3)
            ruleset = {r.strip() for r in rules.split(",") if r.strip()}
            if kind == "disable-file":
                for r in ruleset:
                    self.file_pragmas[r] = why
            else:
                self.pragmas[i] = (ruleset, why)
        self._scopes: List[Tuple[int, int, str]] = []
        self._index_scopes(self.tree, [])

    def _index_scopes(self, node: ast.AST, stack: List[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = stack + [child.name]
                end = getattr(child, "end_lineno", child.lineno) or child.lineno
                self._scopes.append((child.lineno, end, ".".join(qual)))
                self._index_scopes(child, qual)
            else:
                self._index_scopes(child, stack)

    def qualname_at(self, line: int) -> str:
        best = ""
        best_span = None
        for lo, hi, qual in self._scopes:
            if lo <= line <= hi:
                span = hi - lo
                if best_span is None or span < best_span:
                    best, best_span = qual, span
        return best

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Project:
    """Everything a cross-file `finalize` pass may need."""

    def __init__(self, root: str, modules: List[Module], test_text: str):
        self.root = root
        self.modules = modules
        self.test_text = test_text
        self.package_text = "\n".join(m.src for m in modules)


class Checker:
    """Base class: one lint pass, possibly emitting several rule names."""

    rules: Tuple[str, ...] = ()
    description = ""

    def check(self, mod: Module) -> Iterable[Finding]:
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        return ()

    def finding(self, mod: Module, line: int, message: str, rule: str = "",
                severity: str = "error") -> Finding:
        return Finding(rule or self.rules[0], mod.relpath, line, severity,
                       message, qualname=mod.qualname_at(line),
                       line_text=mod.line_text(line))


# -- tree walking -------------------------------------------------------------

def find_root(start: Optional[str] = None) -> str:
    """The repo root: the directory containing the galaxysql_tpu_torch package."""
    here = start or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return here


def iter_sources(root: str, paths: Optional[List[str]] = None
                 ) -> List[Tuple[str, str]]:
    """(relpath, source) for every package file in scope.  tests/ and
    __pycache__/ never participate in tree walks."""
    out = []
    if paths:
        targets = [os.path.join(root, p) if not os.path.isabs(p) else p
                   for p in paths]
    else:
        targets = [os.path.join(root, "galaxysql_tpu_torch")]
    for target in targets:
        if os.path.isfile(target):
            files = [target]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(target):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__" and d != "tests"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(dirpath, fn))
        for f in sorted(files):
            rel = os.path.relpath(f, root)
            if "__pycache__" in rel or rel.startswith("tests" + os.sep):
                continue
            with open(f, "r", encoding="utf-8") as fh:
                out.append((rel.replace(os.sep, "/"), fh.read()))
    return out


def load_test_text(root: str) -> str:
    tdir = os.path.join(root, "tests")
    chunks = []
    if os.path.isdir(tdir):
        for fn in sorted(os.listdir(tdir)):
            if fn.endswith(".py"):
                with open(os.path.join(tdir, fn), "r", encoding="utf-8") as fh:
                    chunks.append(fh.read())
    return "\n".join(chunks)


# -- baseline -----------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def load_baseline(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("entries", []))


def save_baseline(path: str, entries: List[dict]):
    entries = sorted(entries, key=lambda e: (e["path"], e["rule"],
                                             e["qualname"], e["line_text"]))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"comment": "galaxylint grandfathered findings — every "
                              "entry carries a one-line justification; "
                              "stale entries fail the lint run",
                   "entries": entries}, fh, indent=1)
        fh.write("\n")


# -- the run ------------------------------------------------------------------

def run_checkers(modules: List[Module], project: Project,
                 checkers=None) -> List[Finding]:
    from galaxysql_tpu_torch.devtools.checkers import ALL_CHECKERS
    findings: List[Finding] = []
    for ck in (checkers if checkers is not None else ALL_CHECKERS):
        for mod in modules:
            findings.extend(ck.check(mod))
        findings.extend(ck.finalize(project))
    return findings


def apply_pragmas(findings: List[Finding], modules: List[Module]
                  ) -> List[Finding]:
    """Suppress pragma'd findings.  Pragma hygiene is enforced
    unconditionally: a pragma without a justification is a pragma-justify
    finding, and a pragma naming a rule that never fires on its line (typo,
    or the finding was fixed) is a pragma-unknown finding — a suppression
    that suppresses nothing must not look like safety."""
    by_path = {m.relpath: m for m in modules}
    out: List[Finding] = []
    # pass 1: what actually fired, per (path, line) and per path
    fired_line: Dict[Tuple[str, int], set] = {}
    fired_file: Dict[str, set] = {}
    for f in findings:
        fired_line.setdefault((f.path, f.line), set()).add(f.rule)
        fired_file.setdefault(f.path, set()).add(f.rule)
    # pass 2: suppression
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None:
            if f.rule in mod.file_pragmas:
                if mod.file_pragmas[f.rule]:
                    f.suppressed = "pragma"
            else:
                pr = mod.pragmas.get(f.line)
                if pr is not None and f.rule in pr[0] and pr[1]:
                    f.suppressed = "pragma"
        out.append(f)
    # pass 3: pragma hygiene (independent of whether anything fired)
    for mod in modules:
        for line, (rules, why) in mod.pragmas.items():
            if not why:
                out.append(Finding(
                    "pragma-justify", mod.relpath, line, "error",
                    "suppression without a justification (use `# galaxylint: "
                    "disable=<rule> -- <one-line why>`)",
                    qualname=mod.qualname_at(line),
                    line_text=mod.line_text(line)))
            for r in rules - fired_line.get((mod.relpath, line), set()):
                out.append(Finding(
                    "pragma-unknown", mod.relpath, line, "error",
                    f"pragma disables {r!r} but no such finding fires on "
                    f"this line (typo, or the finding was fixed — delete "
                    f"the pragma)", qualname=mod.qualname_at(line),
                    line_text=mod.line_text(line)))
        for r, why in mod.file_pragmas.items():
            if not why:
                out.append(Finding(
                    "pragma-justify", mod.relpath, 1, "error",
                    f"file-level disable={r} has no justification "
                    f"(add `-- why`)"))
            if r not in fired_file.get(mod.relpath, set()):
                out.append(Finding(
                    "pragma-unknown", mod.relpath, 1, "error",
                    f"file-level pragma disables {r!r} but no such finding "
                    f"fires anywhere in this file — delete it"))
    return out


def apply_baseline(findings: List[Finding], entries: List[dict]
                   ) -> List[Finding]:
    index: Dict[Tuple[str, str, str, str], dict] = {}
    for e in entries:
        index[(e["rule"], e["path"], e.get("qualname", ""),
               e.get("line_text", ""))] = e
    matched = set()
    for f in findings:
        if f.suppressed:
            continue
        e = index.get(f.key())
        if e is not None:
            matched.add(id(e))
            if e.get("why"):
                f.suppressed = "baseline"
            # an unjustified baseline entry suppresses nothing
    out = list(findings)
    for e in entries:
        if not e.get("why"):
            out.append(Finding("baseline-justify", e["path"], 0, "error",
                               f"baseline entry for {e['rule']} has no "
                               f"justification", qualname=e.get("qualname", ""),
                               line_text=e.get("line_text", "")))
        elif id(e) not in matched:
            out.append(Finding("baseline-stale", e["path"], 0, "error",
                               f"baseline entry no longer matches anything "
                               f"(rule={e['rule']}, scope="
                               f"{e.get('qualname', '')!r}) — delete it",
                               qualname=e.get("qualname", ""),
                               line_text=e.get("line_text", "")))
    return out


def collect(root: Optional[str] = None, paths: Optional[List[str]] = None,
            baseline_path: Optional[str] = None, checkers=None
            ) -> List[Finding]:
    """Full pipeline: walk -> check -> pragmas -> baseline.  Returns EVERY
    finding; unsuppressed ones are the failures."""
    root = root or find_root()
    modules = []
    for rel, src in iter_sources(root, paths):
        modules.append(Module(rel, src))
    project = Project(root, modules, load_test_text(root))
    findings = run_checkers(modules, project, checkers)
    findings = apply_pragmas(findings, modules)
    entries = load_baseline(baseline_path or BASELINE_PATH)
    findings = apply_baseline(findings, entries)
    return findings


def lint_source(src: str, relpath: str = "galaxysql_tpu_torch/fixture.py",
                checkers=None, test_text: str = "") -> List[Finding]:
    """Lint a source string (the test-fixture entry point).  Pragmas apply;
    no baseline."""
    mod = Module(relpath, src)
    project = Project("", [mod], test_text)
    findings = run_checkers([mod], project, checkers)
    return apply_pragmas(findings, [mod])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="galaxylint",
        description="repo-specific concurrency/jit/typed-error/hygiene lint")
    ap.add_argument("paths", nargs="*", help="files or dirs (default: the "
                    "whole galaxysql_tpu_torch package)")
    ap.add_argument("--baseline", default=None, help="baseline json path")
    ap.add_argument("--update-baseline", action="store_true",
                    help="add currently-unsuppressed findings to the baseline")
    ap.add_argument("--why", default="", help="justification recorded for "
                    "entries added by --update-baseline")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--show-suppressed", action="store_true")
    args = ap.parse_args(argv)

    from galaxysql_tpu_torch.devtools.checkers import ALL_CHECKERS
    if args.list_rules:
        for ck in ALL_CHECKERS:
            for r in ck.rules:
                print(f"{r}: {ck.description}")
        print("pragma-justify: suppression pragmas must carry a one-line why")
        print("pragma-unknown: a pragma must suppress a finding that "
              "actually fires there")
        print("baseline-justify/baseline-stale: baseline entries must be "
              "justified and must still match")
        return 0

    baseline_path = args.baseline or BASELINE_PATH
    findings = collect(paths=args.paths or None, baseline_path=baseline_path)
    open_findings = [f for f in findings if not f.suppressed]

    if args.update_baseline:
        if not args.why:
            print("--update-baseline requires --why (every baseline entry "
                  "carries a justification)", file=sys.stderr)
            return 2
        entries = load_baseline(baseline_path)
        known = {(e["rule"], e["path"], e.get("qualname", ""),
                  e.get("line_text", "")) for e in entries}
        added = 0
        for f in open_findings:
            if f.rule in ("baseline-stale", "baseline-justify",
                          "pragma-justify"):
                continue  # meta-findings are never grandfathered
            if f.key() in known:
                continue
            known.add(f.key())
            entries.append({"rule": f.rule, "path": f.path,
                            "qualname": f.qualname, "line_text": f.line_text,
                            "why": args.why})
            added += 1
        save_baseline(baseline_path, entries)
        print(f"baseline: {added} entr{'y' if added == 1 else 'ies'} added")
        return 0

    shown = findings if args.show_suppressed else open_findings
    for f in sorted(shown, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    print(f"galaxylint: {len(open_findings)} finding(s), "
          f"{n_sup} suppressed (pragma/baseline)")
    return 1 if open_findings else 0


if __name__ == "__main__":
    sys.exit(main())

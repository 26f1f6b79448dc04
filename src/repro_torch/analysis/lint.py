"""repro_torch.analysis.lint — the port's static checks, stdlib-only.

AST-based rules encoding the bug classes the repo has shipped, rewritten
for the port's eager PyTorch and ctypes code: host syncs in the bodies
that run on the device's stream per step or per drain (``host-sync``),
int64 id arrays and dtype-less ``frombuffer`` views (``id-dtype``),
ops<->ref twin pairing, protocol-state mutation outside the owning module,
ctypes launcher tables that disagree with their ``extern "C"`` signatures
(``ctypes-sig``, the port's counterpart of the reference's
``static-args``), unpadded compact axes feeding kernel dispatches, event
determinism in ``core/`` and static trace event names.

Stdlib-only by design: the lint imports neither torch, jax nor repro.

Usage::

    python -m repro_torch.analysis.lint                # vs the baseline
    python -m repro_torch.analysis.lint --no-baseline  # strict (no baseline)
    python -m repro_torch.analysis.lint --write-baseline
    python -m repro_torch.analysis.lint path/to/file.py

An intentional exemption carries an inline ``# lint: allow(<rule>): <why>``
on (or directly above) the flagged line; an allow comment without a reason
does not suppress.  Everything else unbaselined exits non-zero.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Set

HERE = Path(__file__).resolve().parent
SRC_ROOT = HERE.parents[1]              # .../src
REPO_ROOT = SRC_ROOT.parent
DEFAULT_BASELINE = HERE / "lint_baseline.txt"
DEFAULT_TARGET = SRC_ROOT / "repro_torch"

ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([A-Za-z0-9_-]+)\)[:\s-]*(.*)")


@dataclass(frozen=True)
class Violation:
    path: str           # repo-relative posix path
    line: int
    rule: str
    msg: str

    @property
    def key(self) -> str:
        # line-free so baseline entries survive unrelated edits above them
        return f"{self.path}::{self.rule}::{self.msg}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


class Project:
    """Repo context rules may consult (ops<->ref pairing, tests)."""

    def __init__(self, src_root: Path = SRC_ROOT,
                 repo_root: Path = REPO_ROOT) -> None:
        self.src_root = src_root
        self.repo_root = repo_root
        self._tests: Optional[str] = None

    def read_text(self, rel: str) -> Optional[str]:
        try:
            return (self.repo_root / rel).read_text()
        except OSError:
            return None

    def tests_text(self) -> str:
        """Concatenated tests/ sources (cached) — parity-test existence."""
        if self._tests is None:
            chunks: List[str] = []
            tdir = self.repo_root / "tests"
            if tdir.is_dir():
                for p in sorted(tdir.glob("**/*.py")):
                    try:
                        chunks.append(p.read_text())
                    except OSError:
                        pass
            self._tests = "\n".join(chunks)
        return self._tests


class FileCtx:
    """One parsed source file handed to every rule."""

    def __init__(self, path: Path, rel: str, src: str,
                 project: Project) -> None:
        self.path = path
        self.rel = rel
        self.src = src
        self.project = project
        self.tree = ast.parse(src, filename=str(path))
        self.lines = src.splitlines()

    def violation(self, node: ast.AST, rule: str, msg: str) -> Violation:
        return Violation(self.rel, getattr(node, "lineno", 0) or 0, rule, msg)


def apply_allows(ctx: FileCtx, violations: Sequence[Violation]
                 ) -> List[Violation]:
    """Apply inline ``# lint: allow(<rule>): <reason>`` suppressions.

    The comment must sit on the flagged line or in the contiguous comment
    block directly above it, name the rule, and carry a reason — a
    reasonless allow keeps the violation (with a note) so exemptions stay
    self-documenting.
    """
    allows = {}
    for i, text in enumerate(ctx.lines, start=1):
        m = ALLOW_RE.search(text)
        if m:
            allows[i] = (m.group(1), m.group(2).strip())

    def find(line: int):
        a = allows.get(line)
        # walk up through the contiguous comment block above the flagged
        # line (allow comments often wrap onto a second line)
        k = line - 1
        while a is None and 1 <= k <= len(ctx.lines) \
                and ctx.lines[k - 1].lstrip().startswith("#"):
            a = allows.get(k)
            k -= 1
        return a

    out: List[Violation] = []
    for v in violations:
        a = find(v.line)
        if a and a[0] == v.rule:
            if len(a[1]) >= 3:
                continue
            out.append(Violation(v.path, v.line, v.rule,
                                 v.msg + " (allow comment lacks a reason)"))
            continue
        out.append(v)
    return out


def lint_paths(paths: Sequence, project: Optional[Project] = None
               ) -> List[Violation]:
    from .rules import ALL_RULES

    project = project or Project()
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: List[Violation] = []
    for f in files:
        try:
            rel = f.resolve().relative_to(project.repo_root).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            ctx = FileCtx(f, rel, f.read_text(), project)
        except SyntaxError as e:
            out.append(Violation(rel, e.lineno or 0, "parse",
                                 f"syntax error: {e.msg}"))
            continue
        vs: List[Violation] = []
        for rule in ALL_RULES:
            vs.extend(rule.check(ctx))
        out.extend(apply_allows(ctx, vs))
    return out


def load_baseline(path: Path) -> Set[str]:
    try:
        text = path.read_text()
    except OSError:
        return set()
    out = set()
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def write_baseline(path: Path, violations: Sequence[Violation]) -> int:
    keys = sorted({v.key for v in violations})
    header = ("# repro_torch.analysis.lint baseline — known legacy "
              "violations.\n"
              "# New violations fail CI; burn these down, never add here\n"
              "# by hand (use --write-baseline).  Hot-path files (kernels/,\n"
              "# plan/) must stay absent: fix or inline-allow there.\n")
    path.write_text(header + "\n".join(keys) + ("\n" if keys else ""))
    return len(keys)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_TARGET})")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file of tolerated legacy violations")
    ap.add_argument("--no-baseline", action="store_true",
                    help="strict mode: ignore the baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current violations")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    from .rules import ALL_RULES

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id}: {rule.doc}")
        return 0

    paths = args.paths or [DEFAULT_TARGET]
    violations = lint_paths(paths)
    if args.write_baseline:
        n = write_baseline(Path(args.baseline), violations)
        print(f"wrote {n} baseline entr{'y' if n == 1 else 'ies'} "
              f"to {args.baseline}")
        return 0
    baseline = set() if args.no_baseline else load_baseline(
        Path(args.baseline))
    fresh = [v for v in violations if v.key not in baseline]
    matched = {v.key for v in violations} & baseline
    for v in fresh:
        print(v.render())
    stale = len(baseline) - len(matched)
    print(f"{len(fresh)} violation(s), {len(violations) - len(fresh)} "
          f"baselined, {stale} stale baseline entr"
          f"{'y' if stale == 1 else 'ies'}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())

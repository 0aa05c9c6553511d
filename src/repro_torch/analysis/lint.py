"""Repo lint of the port: AST rules for the round path's contracts.

Standard library only (``ast``), so it runs wherever the code does::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch

Rules (each finding names its rule):

``host-sync``
    No wait for the card in the round-path modules (``fl/engine.py``,
    ``core/round.py``, ``core/cache_store.py``, ``obs/metrics.py``):
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``np.asarray``, ``float/int/bool(...)`` of a call, and the
    shape-dependent ops that read their size back (``nonzero``,
    ``masked_select``, ``unique``) — except in the body of a ``with
    host_readback(...)``, the port's one sanctioned seam, and in the
    functions of ``HOST_SYNC_ALLOWLIST`` (construction, the host
    reference loop, the host store's own plumbing).

``mutable-global``
    No module-global mutable singletons (``NAME = SomeClass()`` at
    module level, the removed ``cache_store.STATS`` pattern).  Per-engine
    state belongs on the engine; registries are dict literals.

``registry``
    Every ``@register_policy`` / ``@register_dynamics`` /
    ``@register_agg_rule`` / ``@register_metric`` /
    ``@register_adversary`` target registers a string literal and has a
    docstring, and ``FLConfig.__post_init__`` validates each registry
    axis it configures (``available_agg_rules`` /
    ``available_adversaries`` / ``available_dynamics``).

``round-determinism``
    No host clock or host RNG (``time.*``, ``datetime.*``, ``random.*``,
    ``np.random.*``, ``torch.manual_seed`` / ``torch.seed``) in the round
    functions — the trainer, the round cut, the server step and the
    metrics (``ROUND_FUNCTIONS`` and every ``@register_metric`` target):
    their randomness comes in as arguments, so a run is reproducible
    from its seeds.  (The reference's ``jit-determinism``: there no
    host value may be baked into a jitted trace.)

``deprecated-stats``
    No reference to the removed module-global ``cache_store.STATS``.

To extend the allowlist, add the function's qualified name (e.g.
``"FleetEngine._host_rounds"``) under its module, with a comment saying
why the wait is legitimate.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# Rule configuration
# ---------------------------------------------------------------------------

#: modules whose code IS the per-round hot path — a wait for the card
#: here stalls the pipelined round loop
ROUND_PATH_MODULES = (
    "repro_torch/fl/engine.py",
    "repro_torch/core/round.py",
    "repro_torch/core/cache_store.py",
    "repro_torch/obs/metrics.py",
)

#: documented host-sync seams outside a ``with host_readback`` body, by
#: qualified name (the reference's list); a name covers everything
#: nested inside it
HOST_SYNC_ALLOWLIST: Dict[str, Set[str]] = {
    "repro_torch/fl/engine.py": {
        # construction-time placement (before any round runs)
        "make_trainer",
        "FleetEngine.__init__",
        # the round ledger: THE read-back seam of the device loop
        "_RoundLedger.resolve",
        "_RoundLedger.push",
        # run()-scoped seams outside the round loop and the policy
        # upload boundary
        "FleetEngine.run",
        "FleetEngine._from_plan",
        "FleetEngine._validate_plan",
        "FleetEngine._book_round",
        "FleetEngine._close_round",
        # the host-RNG reference loop reads back by design
        "FleetEngine._host_rounds",
        # the memory profile (tooling, not a round)
        "FleetEngine.server_step_memory",
        # History (de)serialisation is host-side by definition
        "History.to_json",
        "History.from_json",
    },
    "repro_torch/core/round.py": {
        # the numpy round cut of the host loop
        "host_round_cut",
    },
    "repro_torch/core/cache_store.py": {
        # the host store's own plumbing: gather / apply run on host
        # rows, and the stream's reads are the documented fetch path
        # (counted in TransferStats.pre_issued_reads)
        "_tree_bytes",
        "HostCacheStore",
        "CohortCacheStream",
    },
}

#: the round functions of ``round-determinism``, by module: everything
#: nested inside these factories runs every round
ROUND_FUNCTIONS: Dict[str, Set[str]] = {
    "repro_torch/fl/engine.py": {"make_trainer"},
    "repro_torch/core/round.py": {"make_server_round_step",
                                  "make_round_cut"},
    "repro_torch/obs/metrics.py": {"make_metrics_fn"},
}

#: sanctioned module-global singletons (immutable or stateless objects)
MUTABLE_GLOBAL_ALLOWLIST: Set[Tuple[str, str]] = {
    # stateless no-op tracer: every method is a constant-return stub
    ("repro_torch/obs/trace.py", "NULL_TRACER"),
    ("repro_torch/obs/trace.py", "_NULL_SPAN"),
}

_REGISTER_DECORATORS = frozenset({
    "register_policy", "register_dynamics", "register_agg_rule",
    "register_metric", "register_adversary",
})

#: registry axes FLConfig configures -> the validator its
#: ``__post_init__`` must call
_POST_INIT_VALIDATORS = (
    "available_agg_rules", "available_adversaries", "available_dynamics",
)

_NONDET_PREFIXES = (
    "time.", "datetime.", "random.", "np.random.", "numpy.random.",
)
_NONDET_CALLS = ("torch.manual_seed", "torch.seed")

#: method names that read a tensor back to the host
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: ops whose output size depends on the data: the card reports it back
_SHAPE_SYNC = ("nonzero", "masked_select", "unique")

_CAMEL_RE = re.compile(r"^_?[A-Z][A-Za-z0-9]*$")


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None if
    the chain ends in something that is not a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _covered(qualname: str, allow: Set[str]) -> bool:
    return any(qualname == a or qualname.startswith(a + ".")
               for a in allow)


class _ScopedVisitor(ast.NodeVisitor):
    """Tracks the qualified name of the enclosing def / class."""

    def __init__(self) -> None:
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


# ---------------------------------------------------------------------------
# Rule: host-sync
# ---------------------------------------------------------------------------

def _is_readback_seam(item: ast.withitem) -> bool:
    call = item.context_expr
    if not isinstance(call, ast.Call):
        return False
    name = _dotted(call.func) or ""
    return name.rsplit(".", 1)[-1] == "host_readback"


class _HostSyncVisitor(_ScopedVisitor):
    def __init__(self, path: str, allow: Set[str]) -> None:
        super().__init__()
        self.path = path
        self.allow = allow
        self.findings: List[LintFinding] = []
        self._seam = 0

    def _flag(self, node: ast.AST, what: str) -> None:
        if self._seam or _covered(self.qualname, self.allow):
            return
        self.findings.append(LintFinding(
            self.path, node.lineno, "host-sync",
            f"{what} in round-path code ({self.qualname}) — a wait for "
            f"the card every round; move it into the round ledger's row, "
            f"behind a `with host_readback(...)`, or add the function "
            f"to HOST_SYNC_ALLOWLIST with a justification"))

    def visit_With(self, node: ast.With) -> None:
        seam = any(_is_readback_seam(i) for i in node.items)
        for item in node.items:
            self.visit(item)
        self._seam += seam
        for stmt in node.body:
            self.visit(stmt)
        self._seam -= seam

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if dotted is not None and dotted.split(".", 1)[0] in (
                "np", "numpy") and dotted.endswith(".asarray"):
            self._flag(node, f"{dotted}()")
        elif attr in _SYNC_METHODS and not node.args:
            self._flag(node, f".{attr}()")
        elif attr in _SHAPE_SYNC:
            self._flag(node, f"{attr}() (its output size is read back)")
        elif isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") and node.args \
                and isinstance(node.args[0], ast.Call):
            self._flag(node, f"{node.func.id}() of a call's result")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Rule: mutable-global
# ---------------------------------------------------------------------------

def _check_mutable_globals(path: str, key: str, tree: ast.Module,
                           ) -> List[LintFinding]:
    findings = []
    for node in tree.body:
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        callee = _dotted(value.func)
        terminal = callee.rsplit(".", 1)[-1] if callee else ""
        if not _CAMEL_RE.match(terminal):
            continue
        # *Config classes are frozen dataclasses: module-level
        # CONFIG = ModelConfig(...) constants are immutable
        if terminal.endswith("Config"):
            continue
        for t in targets:
            if not (isinstance(t, ast.Name) and t.id.isupper()):
                continue
            if (key, t.id) in MUTABLE_GLOBAL_ALLOWLIST:
                continue
            findings.append(LintFinding(
                path, node.lineno, "mutable-global",
                f"module-global singleton {t.id} = {terminal}(...) — the "
                f"removed STATS pattern; hold per-engine state on the "
                f"engine (or allowlist a stateless object in "
                f"MUTABLE_GLOBAL_ALLOWLIST)"))
    return findings


# ---------------------------------------------------------------------------
# Rule: registry
# ---------------------------------------------------------------------------

def _check_registries(path: str, tree: ast.Module) -> List[LintFinding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        for deco in node.decorator_list:
            if not isinstance(deco, ast.Call):
                continue
            name = _dotted(deco.func)
            terminal = name.rsplit(".", 1)[-1] if name else ""
            if terminal not in _REGISTER_DECORATORS:
                continue
            if not (deco.args and isinstance(deco.args[0], ast.Constant)
                    and isinstance(deco.args[0].value, str)):
                findings.append(LintFinding(
                    path, deco.lineno, "registry",
                    f"@{terminal} on {node.name} must register a string "
                    f"literal name (found a computed value) — registry "
                    f"names are config values and must be greppable"))
            if ast.get_docstring(node) is None:
                findings.append(LintFinding(
                    path, node.lineno, "registry",
                    f"@{terminal} target {node.name} has no docstring — "
                    f"registered names are user-facing config values "
                    f"and must be documented"))
    return findings


def _check_post_init(path: str, tree: ast.Module) -> List[LintFinding]:
    """``FLConfig.__post_init__`` must validate each registry axis it
    configures (``repro_torch/configs/base.py`` only)."""
    post_init = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "FLConfig":
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "__post_init__":
                    post_init = item
    if post_init is None:
        return [LintFinding(
            path, 1, "registry",
            "FLConfig has no __post_init__ — registry names "
            "(agg_rule / adversary / dynamics) must fail at config "
            "construction")]
    used = {n.id for n in ast.walk(post_init) if isinstance(n, ast.Name)}
    used |= {n.attr for n in ast.walk(post_init)
             if isinstance(n, ast.Attribute)}
    return [
        LintFinding(
            path, post_init.lineno, "registry",
            f"FLConfig.__post_init__ does not validate against "
            f"{validator}() — unknown registry names must be rejected "
            f"at config construction, not inside a round")
        for validator in _POST_INIT_VALIDATORS if validator not in used
    ]


# ---------------------------------------------------------------------------
# Rule: round-determinism
# ---------------------------------------------------------------------------

def _is_metric_decorator(deco: ast.expr) -> bool:
    if isinstance(deco, ast.Call):
        deco = deco.func
    name = _dotted(deco) or ""
    return name.rsplit(".", 1)[-1] == "register_metric"


def _nondet_calls(root: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted and (dotted in _NONDET_CALLS or any(
                    dotted.startswith(p) for p in _NONDET_PREFIXES)):
                yield node


def _check_round_determinism(path: str, key: str, tree: ast.Module,
                             ) -> List[LintFinding]:
    findings = []
    roots = ROUND_FUNCTIONS.get(key, set())
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in roots \
                or any(_is_metric_decorator(d) for d in node.decorator_list):
            for call in _nondet_calls(node):
                findings.append(LintFinding(
                    path, call.lineno, "round-determinism",
                    f"{_dotted(call.func)}() inside the round function "
                    f"{node.name} — a host clock or host RNG value makes "
                    f"the round irreproducible from its seeds; pass the "
                    f"value (or a seeded torch.Generator) in"))
    return findings


# ---------------------------------------------------------------------------
# Rule: deprecated-stats
# ---------------------------------------------------------------------------

def _check_deprecated_stats(path: str, tree: ast.Module,
                            ) -> List[LintFinding]:
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "STATS":
            findings.append(LintFinding(
                path, node.lineno, "deprecated-stats",
                "reference to the removed module-global cache_store."
                "STATS — use the per-engine engine.transfer_stats"))
        elif isinstance(node, ast.ImportFrom) \
                and (node.module or "").endswith("cache_store") \
                and any(a.name == "STATS" for a in node.names):
            findings.append(LintFinding(
                path, node.lineno, "deprecated-stats",
                "import of the removed cache_store.STATS — use the "
                "per-engine engine.transfer_stats"))
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "STATS"
                for t in node.targets):
            findings.append(LintFinding(
                path, node.lineno, "deprecated-stats",
                "module-global STATS assignment — transfer counters are "
                "per-engine"))
    return findings


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _module_key(path: str) -> str:
    """Package-relative module key ("repro_torch/fl/engine.py")."""
    norm = path.replace(os.sep, "/")
    i = norm.rfind("repro_torch/")
    return norm[i:] if i >= 0 else os.path.basename(norm)


def lint_source(src: str, module_key: str, path: str = "<memory>",
                ) -> List[LintFinding]:
    tree = ast.parse(src, filename=path)
    findings: List[LintFinding] = []
    if module_key in ROUND_PATH_MODULES:
        visitor = _HostSyncVisitor(
            path, HOST_SYNC_ALLOWLIST.get(module_key, set()))
        visitor.visit(tree)
        findings += visitor.findings
    findings += _check_mutable_globals(path, module_key, tree)
    findings += _check_registries(path, tree)
    if module_key == "repro_torch/configs/base.py":
        findings += _check_post_init(path, tree)
    findings += _check_round_determinism(path, module_key, tree)
    findings += _check_deprecated_stats(path, tree)
    return sorted(findings, key=lambda f: (f.path, f.line))


def lint_file(path: str) -> List[LintFinding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), _module_key(path), path)


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif p.endswith(".py"):
            yield p


def lint_paths(paths: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for path in iter_python_files(paths):
        findings += lint_file(path)
    return findings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST lint of the port's round-path contracts "
                    "(standard library only).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to lint")
    args = parser.parse_args(argv)
    paths = args.paths or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in iter_python_files(paths))
    print(f"linted {n_files} files: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

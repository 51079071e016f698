"""Layer 1 — AST lint: the port's invariants as executable rules (REP001–005).

Counterpart of ``repro.analysis.lint``, with its machinery (``Finding``,
``ParsedModule``, ``Rule``, the call-graph ``RepoContext``, the baseline,
the generated README table) and its rules restated for PyTorch over
``src/repro_torch`` (REP002 also over ``examples/torch`` and
``chip_smoke.py``).  Each rule's docstring opens with the invariant, and
its first body paragraph is the rationale; the README rule table is
generated from exactly those (``python -m repro_torch.analysis.lint
--write``, byte agreement held by ``tests/test_torch_analysis.py``).

Suppression: a finding is silenced by an inline comment **on the same
line**, with a mandatory justification::

    ids_np = inp.ids.cpu().numpy()  # repro: noqa REP003 -- host store boundary

Reason-less ``noqa`` comments are ignored: a suppression without a
justification is itself a convention violation.

Grandfathered findings live in ``baseline.txt`` beside this file
(regenerate with ``--baseline``); the CLI exits non-zero only on findings
absent from it.  It ships empty.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]  # the checkout: src/, examples/, chip_smoke.py
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.txt"
README_PATH = Path(__file__).resolve().parent / "README.md"
PACKAGE = "repro_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*noqa\s+(?P<ids>REP\d{3}(?:\s*,\s*REP\d{3})*)\s*--\s*(?P<reason>\S.*)$"
)


# ------------------------------------------------------------------ model
@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix, relative to the checkout (or the virtual path given to lint_sources)
    line: int
    col: int
    message: str
    line_text: str

    @property
    def baseline_key(self) -> str:
        # keyed on content, not line number, so unrelated edits above a
        # grandfathered line do not churn the baseline
        return f"{self.path}::{self.rule}::{self.line_text.strip()}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class ParsedModule:
    """One source file: AST + parent links + import map + suppressions."""

    def __init__(self, path: str, source: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.imports = _import_map(self.tree)
        self.suppressions: Dict[int, Tuple[set, str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                ids = {s.strip() for s in m.group("ids").split(",")}
                self.suppressions[i] = (ids, m.group("reason").strip())

    @property
    def dotted(self) -> str:
        """Module import path, derived from the file path (``repro_torch.…``)."""
        parts = Path(self.path).with_suffix("").parts
        if PACKAGE in parts:
            parts = parts[parts.index(PACKAGE):]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    @property
    def in_package(self) -> bool:
        return f"src/{PACKAGE}/" in f"/{self.path}" or self.path.startswith(f"{PACKAGE}/")

    def line_text(self, lineno: int) -> str:
        return self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        sup = self.suppressions.get(lineno)
        return bool(sup and rule in sup[0])


def _import_map(tree: ast.Module) -> Dict[str, str]:
    """Local alias → fully dotted path (``F`` → ``torch.nn.functional``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _dotted(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain to a dotted path through the import map."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(imports.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def _region(fn: ast.AST) -> Iterator[ast.AST]:
    """All nodes of ``fn``'s body without descending into nested defs
    (nested functions are separate call-graph nodes; lambdas are part of
    the enclosing region)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


# ------------------------------------------------------------------ rules
class Rule:
    id: str = "REP000"
    scope_doc: str = "src/repro_torch"

    def applies(self, mod: ParsedModule) -> bool:
        return mod.in_package

    def check(self, mod: ParsedModule, ctx: "RepoContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ParsedModule, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, mod.path, node.lineno, node.col_offset,
                       message, mod.line_text(node.lineno))


class REP001(Rule):
    """No name-keyed algorithm branches in ``core/``, ``kernels/``, ``sharding/``.

    Algorithms are ``AlgorithmSpec`` data; the registry is the only
    dispatch point.  A ``cfg.algo == "fedcm"`` branch in the engine or
    kernels silently diverges the moment a new spec registers, so any
    comparison of an ``algo``-named value against string literals is a
    finding.
    """

    id = "REP001"
    scope_doc = "core/, kernels/, sharding/"

    def applies(self, mod):
        return mod.in_package and any(
            seg in mod.path for seg in ("/core/", "/kernels/", "/sharding/"))

    @staticmethod
    def _algoish(node: ast.AST, imports: Dict[str, str]) -> bool:
        d = _dotted(node, imports)
        if not d:
            return False
        return any(p in ("algo", "algo_name", "algorithm") for p in d.split("."))

    @staticmethod
    def _has_str(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(REP001._has_str(e) for e in node.elts)
        return False

    def check(self, mod, ctx):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            ok_ops = (ast.Eq, ast.NotEq, ast.In, ast.NotIn)
            if not all(isinstance(op, ok_ops) for op in node.ops):
                continue
            sides = [node.left] + list(node.comparators)
            if any(self._algoish(s, mod.imports) for s in sides) and any(
                self._has_str(s) for s in sides
            ):
                yield self.finding(
                    mod, node,
                    "name-keyed algorithm branch — dispatch through the "
                    "AlgorithmSpec registry, not algo-name strings",
                )


class REP002(Rule):
    """No module of the port imports ``jax``, ``jaxlib`` or the reference package ``repro``.

    The port stands alone on a machine without JAX: its package, its
    examples and the chip smoke script import torch and themselves only,
    and keep their own copy of whatever they need from the reference.
    Only the tests import both packages.
    """

    id = "REP002"
    scope_doc = "src/repro_torch, examples/torch, chip_smoke.py"
    BANNED = ("jax", "jaxlib", "repro")

    def applies(self, mod):
        return True

    def _banned(self, name: Optional[str]) -> bool:
        return bool(name) and name.split(".")[0] in self.BANNED

    def check(self, mod, ctx):
        for node in ast.walk(mod.tree):
            names: List[str] = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            elif isinstance(node, ast.Call):
                d = _dotted(node.func, mod.imports)
                if (d in ("importlib.import_module", "__import__") and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    names = [node.args[0].value]
            for name in names:
                if self._banned(name):
                    yield self.finding(
                        mod, node,
                        f"imports `{name}` — the port imports no JAX and nothing of the "
                        f"reference package; keep a copy of what it needs in repro_torch",
                    )


class REP003(Rule):
    """No host read inside a round.

    A ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``float(tensor)`` / ``print`` / ``torch.cuda.synchronize`` in a
    function a round reaches stalls the host until the card has drained
    its queue, every round, and keeps the round from ever being captured
    as one CUDA graph.  The rule resolves the call graph from the round's
    roots (``FederatedEngine.round_step``, ``_launch``, ``_fold``,
    ``_flat_cohort_pass``, ``_tree_round`` and ``run_rounds_async_on``)
    and walks every reachable function.  ``float``/``int``/``bool`` of
    static values (config attributes, shapes, literals) is exempt.
    """

    id = "REP003"
    scope_doc = "functions reachable from the round's roots (package-wide graph)"

    METHODS = {"item", "tolist", "cpu", "numpy"}
    BANNED_DOTTED = {"torch.cuda.synchronize": "torch.cuda.synchronize"}
    CASTS = {"float", "int", "bool"}
    STATIC_CALLS = {"getattr", "len", "min", "max", "abs", "round", "pow", "sum"}
    STATIC_METHODS = {"numel", "dim", "size", "element_size", "stride", "get"}

    @classmethod
    def _static_arg(cls, node: ast.AST) -> bool:
        """Conservatively: does this expression look like a Python value
        (config attribute chains, shapes, literals) rather than a tensor?"""
        if isinstance(node, (ast.Constant, ast.Attribute)):
            return True
        if isinstance(node, ast.Subscript):
            return cls._static_arg(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in cls.STATIC_METHODS:
                    return True
                return (isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "math")
            return isinstance(node.func, ast.Name) and node.func.id in cls.STATIC_CALLS
        if isinstance(node, ast.BinOp):
            return cls._static_arg(node.left) and cls._static_arg(node.right)
        if isinstance(node, ast.UnaryOp):
            return cls._static_arg(node.operand)
        if isinstance(node, ast.IfExp):
            return all(cls._static_arg(n) for n in (node.body, node.test, node.orelse))
        return False

    def applies(self, mod):
        return mod.in_package

    def check(self, mod, ctx):
        for key in sorted(ctx.reachable):
            fpath, _ = key
            if fpath != mod.path:
                continue
            fn = ctx.functions[key].node
            for node in _region(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in self.METHODS:
                    yield self.finding(mod, node, f".{f.attr}() reads back to the host "
                                                  f"inside a round")
                    continue
                d = _dotted(f, mod.imports)
                if d in self.BANNED_DOTTED:
                    yield self.finding(mod, node, f"`{self.BANNED_DOTTED[d]}` waits for "
                                                  f"the card inside a round")
                    continue
                if isinstance(f, ast.Name):
                    if f.id == "print":
                        yield self.finding(mod, node, "print() inside a round")
                    elif (f.id in self.CASTS and node.args
                          and not self._static_arg(node.args[0])):
                        yield self.finding(
                            mod, node,
                            f"{f.id}() on a (potentially) device value reads it back "
                            "to the host; keep it a tensor, or read static values "
                            "as attributes",
                        )


class REP004(Rule):
    """Every ``torch`` random draw takes an explicit ``generator=``; nothing re-seeds one inside a round.

    A draw from the global generator is not reproducible from the run's
    seed and shares its stream with every other draw in the process;
    re-seeding a generator inside a round correlates rounds that must be
    independent and breaks a resumed run's replay of the stream.  Draws
    are the ``torch.rand*`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` / ``poisson`` functions and the in-place ``uniform_``
    / ``normal_`` / ``random_`` / … methods; a re-seed is a
    ``manual_seed`` / ``seed`` / ``set_state`` call in a function a round
    reaches (REP003's graph).
    """

    id = "REP004"
    scope_doc = "src/repro_torch"

    DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
             "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
    INPLACE = {"uniform_", "normal_", "random_", "exponential_", "bernoulli_",
               "geometric_", "cauchy_", "log_normal_"}
    RESEEDS = {"manual_seed", "seed", "set_state", "manual_seed_all"}

    def _draw(self, node: ast.Call, imports) -> Optional[str]:
        f = node.func
        d = _dotted(f, imports)
        if d and d.startswith("torch.") and d.split(".")[-1] in self.DRAWS and (
                d.count(".") == 1 or d.startswith("torch.random.")):
            return d
        if isinstance(f, ast.Attribute) and f.attr in self.INPLACE:
            return f".{f.attr}"
        return None

    def check(self, mod, ctx):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._draw(node, mod.imports)
            if name and not any(k.arg == "generator" for k in node.keywords):
                yield self.finding(
                    mod, node,
                    f"`{name}` draws from the global generator — pass generator= "
                    f"(a torch.Generator seeded from the run's seed)")
        for key in sorted(ctx.reachable):
            if key[0] != mod.path:
                continue
            for node in _region(ctx.functions[key].node):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self.RESEEDS):
                    yield self.finding(
                        mod, node,
                        f"`.{node.func.attr}()` re-seeds a generator inside a round — "
                        "seed once, before the rounds, and let the stream advance")


class REP005(Rule):
    """Reductions over sub-f32 operands must accumulate/cast in f32.

    Summing a bf16 plane re-associates in bf16, and the drift from round
    to round is unbounded.  Any ``torch`` reduction whose operand is
    freshly cast to a sub-f32 or a variable dtype (``.to(dt)``,
    ``.bfloat16()``, ``.half()``) must either pass ``dtype=torch.float32``
    or immediately ``.to(torch.float32)`` / ``.float()`` the result.
    """

    id = "REP005"
    scope_doc = "src/repro_torch"

    REDUCTIONS = {"sum", "mean", "prod", "dot", "vdot", "tensordot", "matmul", "einsum",
                  "inner", "norm", "mm", "bmm", "nansum", "cumsum"}
    SUB_F32 = {"bfloat16", "float16", "half", "bf16", "fp16", "float8_e4m3fn",
               "float8_e5m2"}
    F32 = {"float32", "float64", "float", "double", "f32"}
    NOT_DTYPE = {"dtype", "device"}  # .to(x.dtype) aligns; .to(x.device) moves

    def _dtype_class(self, node, imports) -> str:
        """'safe' | 'suspect' for the argument of a cast."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return "suspect" if node.value in self.SUB_F32 else "safe"
        d = _dotted(node, imports)
        if d:
            leaf = d.split(".")[-1]
            if leaf.lower() in self.F32 or leaf in self.NOT_DTYPE or "dev" in leaf:
                return "safe"
            return "suspect"  # a sub-f32 literal or a variable dtype
        return "suspect"

    def _cast_suspect(self, call: ast.Call, imports) -> bool:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr in ("bfloat16", "half"):
            return True
        if f.attr not in ("to", "type"):
            return False
        dt = next((k.value for k in call.keywords if k.arg == "dtype"), None)
        if dt is None and call.args:
            dt = call.args[0]
        return dt is not None and self._dtype_class(dt, imports) == "suspect"

    def _is_reduction(self, call: ast.Call, imports) -> bool:
        f = call.func
        d = _dotted(f, imports)
        if d and d.startswith("torch.") and d.split(".")[-1] in self.REDUCTIONS:
            return True
        return isinstance(f, ast.Attribute) and f.attr in {"sum", "mean"}

    def _mitigated(self, call: ast.Call, mod: ParsedModule) -> bool:
        for kw in call.keywords:
            if kw.arg == "dtype" and self._dtype_class(kw.value, mod.imports) == "safe":
                return True
        parent = mod.parents.get(call)
        if isinstance(parent, ast.Attribute) and parent.value is call:
            gp = mod.parents.get(parent)
            if not (isinstance(gp, ast.Call) and gp.func is parent):
                return False
            if parent.attr in ("float", "double"):
                return True
            if parent.attr == "to":
                dt = next((k.value for k in gp.keywords if k.arg == "dtype"), None)
                if dt is None and gp.args:
                    dt = gp.args[0]
                if dt is not None:
                    d = _dotted(dt, mod.imports) or ""
                    return d.split(".")[-1] in self.F32
        return False

    def check(self, mod, ctx):
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and self._is_reduction(node, mod.imports)):
                continue
            operands = list(node.args) + [k.value for k in node.keywords
                                          if k.arg not in ("dtype", "dim", "axis")]
            if isinstance(node.func, ast.Attribute) and not (
                    _dotted(node.func, mod.imports) or "").startswith("torch."):
                operands.append(node.func.value)  # x.to(dt).sum(): the receiver
            suspect = any(
                isinstance(sb, ast.Call) and self._cast_suspect(sb, mod.imports)
                for op in operands for sb in ast.walk(op)
            )
            if suspect and not self._mitigated(node, mod):
                yield self.finding(
                    mod, node,
                    "reduction over a sub-f32 (or unknown-dtype) cast — accumulate "
                    "in f32 (dtype=torch.float32) or .to(torch.float32) the result",
                )


RULES: Sequence[Rule] = (REP001(), REP002(), REP003(), REP004(), REP005())

#: the functions a round starts from (methods of ``FederatedEngine``)
ROUND_ROOTS = ("round_step", "_launch", "_fold", "_flat_cohort_pass", "_tree_round",
               "run_rounds_async_on")
ENGINE_CLASS = "FederatedEngine"


# ---------------------------------------------------------- the round's graph
@dataclass
class _FuncInfo:
    key: Tuple[str, str]  # (path, qualname)
    node: ast.AST
    module: ParsedModule
    parent: Optional[Tuple[str, str]]
    cls: Optional[str]


class RepoContext:
    """Cross-module call graph: the round's roots → reachable functions."""

    def __init__(self, modules: Sequence[ParsedModule]):
        self.modules = list(modules)
        self.by_dotted = {m.dotted: m for m in self.modules}
        self.functions: Dict[Tuple[str, str], _FuncInfo] = {}
        self.children: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        self.modlevel: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.methods: Dict[Tuple[str, str, str], Tuple[str, str]] = {}
        for m in self.modules:
            self._index(m)
        self.reachable = self._reach(self._roots())

    def _index(self, mod: ParsedModule):
        self.modlevel.setdefault(mod.path, {})

        def visit(node, qual, parent_key, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{qual}.{child.name}" if qual else child.name
                    key = (mod.path, q)
                    self.functions[key] = _FuncInfo(key, child, mod, parent_key, cls)
                    if parent_key is not None:
                        self.children.setdefault(parent_key, {})[child.name] = key
                    elif cls is None:
                        self.modlevel[mod.path][child.name] = key
                    if cls is not None and parent_key is None:
                        self.methods[(mod.path, cls, child.name)] = key
                    visit(child, q, key, cls)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{qual}.{child.name}" if qual else child.name,
                          None, child.name)
                else:
                    visit(child, qual, parent_key, cls)

        visit(mod.tree, "", None, None)

    def resolve(self, expr: ast.AST, mod: ParsedModule,
                fkey: Optional[Tuple[str, str]]) -> Optional[Tuple[str, str]]:
        if isinstance(expr, ast.Name):
            k = fkey
            while k is not None:
                hit = self.children.get(k, {}).get(expr.id)
                if hit:
                    return hit
                k = self.functions[k].parent
            hit = self.modlevel.get(mod.path, {}).get(expr.id)
            if hit:
                return hit
            return self._cross(mod.imports.get(expr.id))
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name) and expr.value.id == "self"
                    and fkey is not None):
                cls = self.functions[fkey].cls
                if cls:
                    return self.methods.get((mod.path, cls, expr.attr))
            return self._cross(_dotted(expr, mod.imports))
        return None

    def _cross(self, dotted: Optional[str]) -> Optional[Tuple[str, str]]:
        if not dotted or not dotted.startswith(f"{PACKAGE}."):
            return None
        mod_path, _, fname = dotted.rpartition(".")
        m = self.by_dotted.get(mod_path)
        if m:
            return self.modlevel.get(m.path, {}).get(fname)
        return None

    def _roots(self):
        return {key for (_, cls, name), key in self.methods.items()
                if cls == ENGINE_CLASS and name in ROUND_ROOTS}

    def _reach(self, roots):
        seen = set()
        work = list(roots)
        while work:
            key = work.pop()
            if key in seen or key not in self.functions:
                continue
            seen.add(key)
            info = self.functions[key]
            work.extend(self.children.get(key, {}).values())  # nested defs run with it
            for node in _region(info.node):
                if isinstance(node, (ast.Name, ast.Attribute)):
                    hit = self.resolve(node, info.module, key)
                    if hit and hit not in seen:
                        work.append(hit)
        return seen


# ------------------------------------------------------------------ driver
def iter_repo_files(root: Path = REPO_ROOT) -> Iterator[Path]:
    """The files the rules read: the package, the examples, the smoke script."""
    yield from sorted((root / "src" / PACKAGE).rglob("*.py"))
    yield from sorted((root / "examples" / "torch").glob("*.py"))
    if (root / "chip_smoke.py").exists():
        yield root / "chip_smoke.py"


def lint_modules(modules: Sequence[ParsedModule], rules: Optional[Sequence[Rule]] = None,
                 include_suppressed: bool = False) -> List[Finding]:
    ctx = RepoContext(modules)
    findings: List[Finding] = []
    for rule in (rules or RULES):
        for mod in modules:
            if not rule.applies(mod):
                continue
            for f in rule.check(mod, ctx):
                if include_suppressed or not mod.suppressed(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_sources(named_sources: Dict[str, str], rules: Optional[Sequence[Rule]] = None,
                 include_suppressed: bool = False) -> List[Finding]:
    """Lint in-memory sources (fixture tests): {virtual path: source}."""
    mods = [ParsedModule(p, s) for p, s in sorted(named_sources.items())]
    return lint_modules(mods, rules, include_suppressed)


def lint_repo(root: Path = REPO_ROOT, rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    mods = [ParsedModule(p.relative_to(root).as_posix(), p.read_text())
            for p in iter_repo_files(root)]
    return lint_modules(mods, rules)


# ------------------------------------------------------------------ baseline
def load_baseline(path: Path = BASELINE_PATH) -> set:
    if not path.exists():
        return set()
    return {line.strip() for line in path.read_text().splitlines()
            if line.strip() and not line.strip().startswith("#")}


def write_baseline(findings: Iterable[Finding], path: Path = BASELINE_PATH):
    lines = [
        "# repro_torch.analysis.lint baseline — grandfathered findings.",
        "# One `path::RULE::stripped source line` per entry; regenerate with",
        "#   python -m repro_torch.analysis.lint --baseline",
        "# Keep this empty (or justified line by line): new findings fail the lint.",
    ]
    lines += sorted({f.baseline_key for f in findings})
    path.write_text("\n".join(lines) + "\n")


# ------------------------------------------------------------------ README
README_BEGIN = "<!-- analysis-rules:begin (generated by repro_torch.analysis.lint) -->"
README_END = "<!-- analysis-rules:end -->"


def rule_table_md() -> str:
    """Rule table rendered from the rule docstrings (first line = the
    invariant, first body paragraph = the rationale)."""
    rows = ["| ID | Invariant | Scope | Rationale |",
            "| --- | --- | --- | --- |"]
    for rule in RULES:
        doc = (type(rule).__doc__ or "").strip().splitlines()
        invariant = doc[0].strip().rstrip(".") if doc else ""
        para: List[str] = []
        for ln in (ln.strip() for ln in doc[1:]):
            if not ln and para:
                break
            if ln:
                para.append(ln)
        first = " ".join(para)
        rationale = first.split(". ")[0].rstrip(".") + "." if first else ""
        rows.append(f"| {rule.id} | {invariant}. | `{rule.scope_doc}` | {rationale} |")
    return "\n".join(rows)


def sync_readme(write: bool = False, path: Path = README_PATH) -> bool:
    """True iff the README's generated block byte-matches the rule table
    (with ``write``, rewrite it in place first)."""
    text = path.read_text() if path.exists() else ""
    block = f"{README_BEGIN}\n{rule_table_md()}\n{README_END}"
    if README_BEGIN in text and README_END in text:
        head, _, rest = text.partition(README_BEGIN)
        _, _, tail = rest.partition(README_END)
        new = head + block + tail
    else:
        new = text.rstrip() + "\n\n" + block + "\n"
    if write and new != text:
        path.write_text(new)
        return True
    return new == text


# ------------------------------------------------------------------ CLI
def _main(argv=None) -> int:
    # `python -m` runs this file as __main__: delegate to the canonical
    # import so paths and rule identities come from one module instance
    from repro_torch.analysis import lint as canonical

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description="The port's invariant AST lint (REP001–REP005).")
    ap.add_argument("--baseline", action="store_true",
                    help="rewrite the grandfathered-findings baseline from the current "
                         "findings")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the README rule table in place")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the findings as JSON")
    args = ap.parse_args(argv)

    if args.write:
        changed = canonical.sync_readme(write=True)
        print(f"README rule table {'updated' if changed else 'already current'}")
        return 0
    findings = canonical.lint_repo()
    baseline = canonical.load_baseline()
    if args.baseline:
        canonical.write_baseline(findings)
        print(f"baseline written: {len(findings)} grandfathered finding(s)")
        return 0
    new = [f for f in findings if f.baseline_key not in baseline]
    for f in new:
        print(f)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            [vars(f) | {"baselined": f.baseline_key in baseline} for f in findings],
            indent=2, default=str) + "\n")
    print(f"repro_torch.analysis.lint: {len(new)} new finding(s), "
          f"{len(findings) - len(new)} baselined, {len(canonical.RULES)} rules")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(_main())

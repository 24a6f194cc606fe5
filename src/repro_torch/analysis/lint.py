"""Repo-specific AST lint of the port: past bug classes as mechanical rules
(the counterpart of ``repro.analysis.lint``).

Rules kept from the reference, for the port's code:

* **E2A001**: an in-place write to a host buffer after it was handed to a
  call that may alias it while a copy is in flight, without a snapshot
  (the reference's PR 6 race). The aliasing calls are the reference's
  (``jnp.asarray``, ``jax.device_put``) and the port's: ``torch.from_numpy``,
  ``torch.as_tensor`` and ``torch.asarray`` share the numpy buffer, so a
  later write to it races a ``.to(device, non_blocking=True)`` copy and
  changes the tensor. Pass a ``.copy()`` (or use ``torch.tensor``, which
  copies).
* **E2A005**: a ``DeprecationWarning`` without an explicit ``stacklevel``.
* **E2A006**: a fault-swallowing handler: bare ``except:``, or a broad
  ``except Exception:`` / ``except BaseException:`` whose body is a no-op.

The reference's Pallas rules (E2A002 ``interpret=`` defaults, E2A003 host
numpy in a kernel body, E2A007 ``index_map`` arity) have no object in the
port, and its E2A004 read jit's ``static_argnums``, which the port does
not have: all four are dropped. Rules for the port's own idiom take their
places:

* **E2A101**: an import of ``jax`` or of the reference package ``repro``
  (not ``repro_torch``) in the port's code: ``src/repro_torch/``,
  ``chip_smoke.py``, ``benchmarks/torch/``, ``examples/torch/``. The
  card's machine has no JAX; only the CPU tests (``tests/``) import both.
* **E2A102**: a call of a library entry point, ``build.load().e2a_*``,
  that has no argument types in ``build.SIGNATURES``: ctypes would pass
  every pointer and the stream as a 32-bit int.
* **E2A103**: ``build.load()`` (or ``build.build()``) reached at module
  level: importing the module would compile the kernels, and the CPU tests
  import every module.
* **E2A105**: an ``except`` around a kernel launch whose handler calls a
  plain version (``*_plain``): a fallback that hides the kernel. A wrapper
  takes its plain version for a CPU tensor only, decided by the tensor's
  device, never by a failure.

Findings are suppressed per line with ``# e2a-torch: ignore[E2A101]``
(comma lists allowed; a bare ``# e2a-torch: ignore`` silences every rule)
on the flagged line or the line above. A suppression comment that silences
nothing is itself reported (``lint.ignore``, warning).
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.report import Finding, error, warning

__all__ = ["RULES", "iter_py_files", "lint_paths", "lint_source"]

#: rule id -> one-line description (the CLI prints this catalog).
RULES: dict[str, str] = {
    "E2A001": "in-place write to a host buffer previously handed to an "
              "aliasing call (torch.from_numpy/as_tensor/asarray, "
              "jnp.asarray, jax.device_put) without a .copy() snapshot",
    "E2A005": "DeprecationWarning without an explicit stacklevel",
    "E2A006": "fault-swallowing handler: bare except, or broad "
              "except Exception/BaseException with a no-op body",
    "E2A101": "import of jax or of the reference package repro in the "
              "port's code (src/repro_torch, chip_smoke.py, "
              "benchmarks/torch, examples/torch)",
    "E2A102": "build.load().e2a_* call of an entry point with no "
              "argument types in build.SIGNATURES",
    "E2A103": "build.load()/build.build() reached at module level (a "
              "build at import)",
    "E2A105": "except around a kernel launch whose handler calls a plain "
              "version (a fallback that hides the kernel)",
}

_IGNORE_RE = re.compile(r"#\s*e2a-torch:\s*ignore(?:\[([A-Z0-9,\s]+)\])?")

#: Call targets whose bare array arguments alias host buffers (E2A001).
_DISPATCH_FUNCS = {"jnp.asarray", "jax.numpy.asarray", "jax.device_put",
                   "device_put", "torch.from_numpy", "torch.as_tensor",
                   "torch.asarray"}

#: Call targets that build or load the kernel library (E2A103).
_BUILD_CALLS = {"build.load", "build.build", "kernels.build.load",
                "kernels.build.build"}


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:   # pragma: no cover - malformed node
        return ""


def _ignore_comments(source: str) -> dict[int, set[str] | None]:
    """Line -> rule set of every real ``# e2a-torch: ignore`` *comment
    token* (``None`` = bare ignore, silences every rule); tokens inside
    strings and docstrings do not count."""
    out: dict[int, set[str] | None] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if m:
                out[tok.start[0]] = None if m.group(1) is None else \
                    {r.strip() for r in m.group(1).split(",")}
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass   # unparsable source is reported as lint.parse upstream
    return out


def _suppression_line(ignores: dict[int, set[str] | None], lineno: int,
                      rule: str) -> int | None:
    """The ignore-comment line covering (lineno, rule), or None. A comment
    covers its own line and the line below it."""
    for ln in (lineno, lineno - 1):
        rules = ignores.get(ln, ())
        if rules is None or rule in rules:
            return ln
    return None


def _func_scopes(tree: ast.AST) -> Iterator[ast.AST]:
    """Module plus every function def (each checked as one scope)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _ordered_nodes(scope: ast.AST) -> list[ast.AST]:
    """The scope's own nodes (nested defs excluded), in source order."""
    own: list[ast.AST] = []

    def collect(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue   # nested defs get their own scope
            own.append(child)
            collect(child)

    collect(scope)
    return sorted((n for n in own if hasattr(n, "lineno")),
                  key=lambda n: (n.lineno, n.col_offset))


# -- E2A001 ------------------------------------------------------------------

def _rule_e2a001(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    for scope in _func_scopes(tree):
        dispatched: dict[str, int] = {}
        for node in _ordered_nodes(scope):
            if isinstance(node, ast.Call) and \
                    _unparse(node.func) in _DISPATCH_FUNCS:
                for arg in node.args:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        dispatched[_unparse(arg)] = node.lineno
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for tgt in targets:
                if isinstance(tgt, (ast.Name, ast.Attribute)):
                    # rebinding the name ends the alias hazard
                    dispatched.pop(_unparse(tgt), None)
                elif isinstance(tgt, ast.Subscript):
                    buf = _unparse(tgt.value)
                    at = dispatched.get(buf)
                    if at is not None and node.lineno > at:
                        yield node.lineno, (
                            f"in-place write to {buf!r} after it was "
                            f"handed to an aliasing call at line {at}: the "
                            f"tensor shares this buffer, and a copy still "
                            f"in flight reads the write; snapshot with "
                            f"{buf}.copy() at the call")


# -- E2A005 ------------------------------------------------------------------

def _rule_e2a005(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                _unparse(node.func) in ("warnings.warn", "warn")):
            continue
        if not any("DeprecationWarning" in _unparse(a)
                   for a in list(node.args) + list(node.keywords)):
            continue
        has_stacklevel = (len(node.args) >= 3 or
                          any(kw.arg == "stacklevel"
                              for kw in node.keywords))
        if not has_stacklevel:
            yield node.lineno, (
                "DeprecationWarning without an explicit stacklevel: the "
                "warning will point at the port's internals, not the "
                "user's call site")


# -- E2A006 ------------------------------------------------------------------

def _broad_catch(handler: ast.ExceptHandler) -> str | None:
    """'bare' for ``except:``, the class name for a handler that catches
    Exception/BaseException (directly or inside a tuple), else None."""
    if handler.type is None:
        return "bare"
    elts = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for e in elts:
        if _unparse(e) in ("Exception", "BaseException"):
            return _unparse(e)
    return None


def _noop_body(handler: ast.ExceptHandler) -> bool:
    """True when the handler does nothing: only pass/.../continue (a
    docstring-style constant expression counts as nothing too)."""
    return all(
        isinstance(s, (ast.Pass, ast.Continue)) or
        (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
        for s in handler.body)


def _rule_e2a006(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = _broad_catch(node)
        if broad == "bare":
            yield node.lineno, (
                "bare 'except:' swallows every signal including "
                "KeyboardInterrupt and SystemExit: catch a concrete "
                "exception type (or at most 'except Exception:' with real "
                "handling)")
        elif broad is not None and _noop_body(node):
            yield node.lineno, (
                f"'except {broad}: pass' silently swallows faults: handle, "
                f"narrow or re-raise; if the swallow is deliberate, say so "
                f"with # e2a-torch: ignore[E2A006]")


# -- E2A101 ------------------------------------------------------------------

def _port_code(path: str) -> bool:
    """Whether ``path`` is the port's code, which must not import JAX or
    the reference: everything but the tests (their golden snippets under
    ``tests/data`` are linted as port code)."""
    parts = Path(path).parts
    return "tests" not in parts or "data" in parts


def _forbidden_module(name: str | None) -> bool:
    if not name:
        return False
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _rule_e2a101(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    if not _port_code(path):
        return
    for node in ast.walk(tree):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and \
                _unparse(node.func) in ("importlib.import_module",
                                        "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names = [node.args[0].value]
        for name in names:
            if _forbidden_module(name):
                yield node.lineno, (
                    f"import of {name!r} in the port's code: the card's "
                    f"machine has no JAX and no reference package; keep "
                    f"the port's own copy of what it needs")


# -- E2A102 ------------------------------------------------------------------

def _is_load_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        _unparse(node.func) in ("build.load", "load", "kernels.build.load")


def _rule_e2a102(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    from repro_torch.kernels.build import SIGNATURES

    for scope in _func_scopes(tree):
        libs: set[str] = set()     # names bound to build.load() here
        for node in _ordered_nodes(scope):
            if isinstance(node, ast.Assign) and _is_load_call(node.value):
                libs.update(_unparse(t) for t in node.targets)
            if not (isinstance(node, ast.Attribute) and
                    node.attr.startswith("e2a_")):
                continue
            if _is_load_call(node.value) or _unparse(node.value) in libs:
                if node.attr not in SIGNATURES:
                    yield node.lineno, (
                        f"{node.attr} has no entry in build.SIGNATURES: "
                        f"ctypes passes every pointer and the stream as a "
                        f"32-bit int; declare its argument types")


# -- E2A103 ------------------------------------------------------------------

def _build_names(tree: ast.AST) -> set[str]:
    """``_BUILD_CALLS`` plus the bare names ``load`` / ``build`` where the
    module imports them from the build module."""
    names = set(_BUILD_CALLS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                (node.module or "").endswith("kernels.build"):
            names.update(a.asname or a.name for a in node.names
                         if a.name in ("load", "build"))
    return names


def _rule_e2a103(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    calls = _build_names(tree)

    def walk(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue   # runs when called, not at import
            if isinstance(child, ast.If) and \
                    _unparse(child.test) == "__name__ == '__main__'":
                continue   # the script's entry, not an import
            yield child
            yield from walk(child)

    for node in walk(tree):
        if isinstance(node, ast.Call) and _unparse(node.func) in calls:
            yield node.lineno, (
                f"{_unparse(node.func)}() at module level compiles the "
                f"kernels when the module is imported; call it inside the "
                f"function that launches")


# -- E2A105 ------------------------------------------------------------------

def _launches(node: ast.AST) -> bool:
    """Whether ``node`` calls into the kernel library: ``build.load()``, an
    ``e2a_*`` entry point or a ``_launch*`` helper."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = _unparse(sub.func)
        last = name.rsplit(".", 1)[-1]
        if _is_load_call(sub) or last.startswith(("e2a_", "_launch")):
            return True
    return False


def _calls_plain(handler: ast.ExceptHandler) -> str | None:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Call):
            name = _unparse(sub.func)
            if name.rsplit(".", 1)[-1].endswith("_plain"):
                return name
    return None


def _rule_e2a105(tree: ast.AST, path: str) -> Iterator[tuple[int, str]]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try) or \
                not any(_launches(s) for s in node.body):
            continue
        for handler in node.handlers:
            plain = _calls_plain(handler)
            if plain is not None:
                yield handler.lineno, (
                    f"the handler of a kernel launch falls back to "
                    f"{plain}(): a failed launch would pass as the plain "
                    f"version's result; let it raise (a wrapper takes its "
                    f"plain version for a CPU tensor only)")


_RULE_FNS = {
    "E2A001": _rule_e2a001,
    "E2A005": _rule_e2a005,
    "E2A006": _rule_e2a006,
    "E2A101": _rule_e2a101,
    "E2A102": _rule_e2a102,
    "E2A103": _rule_e2a103,
    "E2A105": _rule_e2a105,
}


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Run every rule over one source text (``path`` decides whether it is
    the port's code, for E2A101). Returns error findings, plus a
    ``lint.ignore`` warning for each ``# e2a-torch: ignore`` comment that
    suppressed nothing."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [error("lint.parse", f"{path}:{e.lineno or 0}",
                      f"syntax error: {e.msg}")]
    ignores = _ignore_comments(source)
    used: set[int] = set()
    findings = []
    for rule, fn in _RULE_FNS.items():
        for lineno, message in fn(tree, path):
            sup = _suppression_line(ignores, lineno, rule)
            if sup is None:
                findings.append(error(rule, f"{path}:{lineno}", message))
            else:
                used.add(sup)
    for ln in sorted(set(ignores) - used):
        named = ignores[ln]
        tag = "" if named is None else f"[{','.join(sorted(named))}]"
        findings.append(warning(
            "lint.ignore", f"{path}:{ln}",
            f"# e2a-torch: ignore{tag} suppresses nothing: no finding on "
            f"this line or the line below matches; drop the stale "
            f"allowlist comment"))
    return findings


#: Directories never linted: golden known-bad snippets live here.
_EXCLUDED_PARTS = {"data", "__pycache__", ".git"}

#: The port's lint surface (the CLI's default ``--paths``), relative to the
#: repository root; ``tests/test_torch_*.py`` are globbed.
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "benchmarks/torch",
                 "examples/torch", "tests/test_torch_*.py")


def iter_py_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if any(ch in p.name for ch in "*?["):
            yield from (f for f in sorted(p.parent.glob(p.name))
                        if f.suffix == ".py")
        elif p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _EXCLUDED_PARTS & set(f.parts):
                    yield f


def lint_paths(paths: Iterable[str | Path]) -> list[Finding]:
    """Lint every ``.py`` under ``paths`` (golden-data dirs excluded; a
    glob in the last component is expanded)."""
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings

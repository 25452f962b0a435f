"""AST-level repo lint: rules about the worker program the type system
can't see.

Port of ``repro/analysis/source.py``: the same two rules, aimed at the
port's hazards.  Both guard "the program a policy runs is a pure
function of the policy value and the data":

- **source-prng-seed**: a seeding call must be given a deterministic
  expression.  The calls are the port's threefry keys
  (``prng.PRNGKey`` / ``prng.key``, and the reference's
  ``jax.random.PRNGKey`` / ``jax.random.key`` spellings) and PyTorch's
  seeding (``torch.manual_seed``, ``torch.cuda.manual_seed``,
  ``torch.Generator(...).manual_seed`` or any generator's
  ``manual_seed``).  A seed drawn from wall-clock time, ``os.urandom``,
  ``torch.seed()`` or a stateful generator (``random``, ``np.random``)
  makes the run, and with it the paper's bit-reproducibility story,
  run-dependent.
- **source-traced-branch**: inside a policy's ``mix(self, x, state,
  ctx)`` body, a Python ``if``/``while`` on the data arguments (``x``,
  ``state``) branches on tensor values.  ``Tensor.__bool__`` on a card
  tensor waits for the card (a host sync every mix), and on the mesh
  the ranks hold different workers, so two ranks can take different
  sides and issue different collectives.  Branching on static config
  (``self.*``, ``ctx.num_workers``) is fine; ``x is None`` identity
  checks are structural, not value branches, and are exempt.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import LintFinding

#: Callables whose result must never seed a generator.
_NONDET_CALLS = {
    "time", "time_ns", "monotonic", "perf_counter", "urandom",
    "getrandbits", "randint", "random", "rand", "token_bytes",
    "seed", "integers", "token_hex", "uuid4",
}

#: Attribute owners of a threefry key call: ``prng.PRNGKey``,
#: ``jax.random.PRNGKey``.
_KEY_OWNERS = ("prng", "random")


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_seed_call(node: ast.Call) -> bool:
    """A threefry key (``prng.PRNGKey(s)``, ``prng.key(s)``, the bare
    ``PRNGKey(s)``) or a PyTorch seeding (``manual_seed(s)`` on torch,
    torch.cuda or any generator)."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == "PRNGKey"
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr in ("manual_seed", "manual_seed_all"):
        return True
    owner = f.value
    owner_name = (
        owner.attr if isinstance(owner, ast.Attribute)
        else owner.id if isinstance(owner, ast.Name) else ""
    )
    return f.attr in ("PRNGKey", "key") and owner_name in _KEY_OWNERS


def _nondeterministic_seed(node: ast.Call) -> str | None:
    if not node.args and not node.keywords:
        return "no seed argument"
    seed = node.args[0] if node.args else node.keywords[0].value
    for sub in ast.walk(seed):
        if isinstance(sub, ast.Call) and _call_name(sub) in _NONDET_CALLS:
            return f"seed derives from {_call_name(sub)}()"
    return None


def _exempt_names(test: ast.expr) -> set[int]:
    """ids of Name nodes used only in `X is None` / `X is not None`."""
    exempt: set[int] = set()
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) and all(
            isinstance(c, ast.Constant) and c.value is None
            for c in node.comparators
        ):
            for sub in [node.left, *node.comparators]:
                if isinstance(sub, ast.Name):
                    exempt.add(id(sub))
    return exempt


def _traced_branches(fn: ast.FunctionDef) -> list[tuple[int, str]]:
    """(lineno, name) for every if/while on a mix data argument."""
    params = [a.arg for a in fn.args.args]
    # def mix(self, x, state, ctx): positions 1 and 2 are the data.
    traced = set(params[1:3]) - {"self"}
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        exempt = _exempt_names(node.test)
        for sub in ast.walk(node.test):
            if (
                isinstance(sub, ast.Name)
                and sub.id in traced
                and id(sub) not in exempt
            ):
                out.append((node.lineno, sub.id))
    return out


def lint_source_text(
    text: str, *, filename: str
) -> list[LintFinding]:
    findings: list[LintFinding] = []
    try:
        tree = ast.parse(text, filename=filename)
    except SyntaxError as e:
        return [LintFinding(
            check="source-syntax",
            subject=f"{filename}:{e.lineno or 0}",
            message=f"file does not parse: {e.msg}",
        )]
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_seed_call(node):
            why = _nondeterministic_seed(node)
            if why:
                findings.append(LintFinding(
                    check="source-prng-seed",
                    subject=f"{filename}:{node.lineno}",
                    message=f"non-deterministic seed: {why}",
                ))
        if isinstance(node, ast.FunctionDef) and node.name == "mix":
            for lineno, name in _traced_branches(node):
                findings.append(LintFinding(
                    check="source-traced-branch",
                    subject=f"{filename}:{lineno}",
                    message=(
                        f"Python branch on mix argument {name!r}: use "
                        "torch.where — Tensor.__bool__ on a card tensor "
                        "forces a host sync every mix, and on the mesh "
                        "two ranks can take different sides"
                    ),
                ))
    return findings


def lint_source_tree(root: str | Path) -> list[LintFinding]:
    root = Path(root)
    findings: list[LintFinding] = []
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root.parent if root.is_dir() else root))
        findings.extend(
            lint_source_text(path.read_text(), filename=rel)
        )
    return findings

"""Every C entry the port binds exists in its CUDA sources.

``_build.kernel_fn(name, ...)`` resolves ``name`` in the kernel library only
when the library loads on the card, so a binding to an entry point the
sources no longer define would fail there alone.  Here every name a
``kernel_fn`` call in ``avr_tpu_torch/`` and ``chip_smoke.py`` can pass is
read from the source (a string literal; a module-level dict's values where
the call indexes one; a local's literals, or the literals callers pass, where
the call passes a name) and held to the ``extern "C"`` functions of
``avr_tpu_torch/csrc/``.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "avr_tpu_torch" / "csrc"


def _defined():
    names = set()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp")):
        names |= set(re.findall(r'extern "C"\s+[\w\s\*]*?\b(\w+)\s*\(', path.read_text()))
    return names


def _strings(node):
    return [n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str)]


def _module_dicts(tree):
    """Module-level dicts by name: their values' string literals."""
    return {t.id: [s for v in n.value.values for s in _strings(v)] for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
            for t in n.targets if isinstance(t, ast.Name)}


def _bound_names(path):
    """(line, names) for each ``kernel_fn`` call in ``path``."""
    tree = ast.parse(path.read_text())
    dicts = _module_dicts(tree)
    funcs = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)]
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)]
    out = []
    for f in funcs:
        for call in ast.walk(f):
            if not (isinstance(call, ast.Call) and getattr(call.func, "attr", None) == "kernel_fn"
                    and call.args):
                continue
            arg = call.args[0]
            if isinstance(arg, ast.Constant):
                names = [arg.value]
            elif isinstance(arg, ast.Subscript) and isinstance(arg.value, ast.Name):
                names = dicts[arg.value.id]
            elif isinstance(arg, ast.Name):
                params = [a.arg for a in f.args.args]
                local = [_strings(n.value) for n in ast.walk(f) if isinstance(n, ast.Assign)
                         and any(getattr(t, "id", None) == arg.id for t in n.targets)]
                if local:
                    names = [s for group in local for s in group]
                else:  # a parameter: what the module's calls of ``f`` pass there
                    pos = params.index(arg.id)
                    names = [c.args[pos].value for c in calls
                             if getattr(c.func, "id", getattr(c.func, "attr", None)) == f.name
                             and len(c.args) > pos and isinstance(c.args[pos], ast.Constant)]
            else:
                raise AssertionError(f"{path.name}:{call.lineno}: kernel_fn of "
                                     f"{ast.dump(arg)} is not read by this test")
            out.append((call.lineno, names))
    return out


FILES = sorted((ROOT / "avr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", [p for p in FILES if "kernel_fn(" in p.read_text()],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_bound_entry_is_defined(path):
    defined = _defined()
    bound = _bound_names(path)
    assert bound or path.name == "_build.py"
    for line, names in bound:
        assert names, f"{path.name}:{line}: no entry name read"
        missing = [n for n in names if n not in defined]
        assert not missing, f"{path.name}:{line}: {missing} not an extern \"C\" in csrc/"


def test_the_retired_entries_are_gone():
    """resnetfc_kernel's entry and the first wide version's are no longer
    in the sources, and nothing binds them."""
    defined = _defined()
    assert {"avr_resnetfc_fwd_bf16", "avr_resnetfc_chain", "avr_resnetfc_fwd_wide_tma"} <= defined
    for gone in ("avr_resnetfc", "avr_resnetfc_fwd_wide", "avr_resnetfc_dgrad_wide"):
        assert gone not in defined
        for path in FILES:
            assert all(gone not in names for _, names in _bound_names(path)), path.name

"""The port's copy of the host layers, and inputs built by each package.

``relp_tpu_torch`` keeps its own copy of the JAX package's host modules
(MPS import, GeneralForm, presolve, scaling, providers, exact
certification, rational helpers, sparse algebra, lowering, results,
checkpoints): it imports nothing of ``relp_tpu``.  Each copy must equal its
original after the rename ``relp_tpu.`` -> ``relp_tpu_torch.``, apart from
the lines listed in ``ALLOWED`` and ``OWN_LINES`` and the functions in
``OWN_FUNCTION``, so that drift between the two shows here.

``twin`` gives the port's tests the inputs of a JAX-side test helper built
by the port's own classes (and ``relp_tpu_torch.testing`` built by the JAX
package's): the helper's source with the package name rewritten, run as a
module of its own.  No object of one package is ever handed to the other.
"""

import ast
import importlib.util
import pathlib
import re
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Every host module of relp_tpu that the port copies, by path under the
# package; the copy lies at the same path under relp_tpu_torch/.
COPIED = (
    "io/__init__.py", "io/errors.py", "io/mps.py", "io/convert.py",
    "io/native.py",
    "data/__init__.py", "data/elements.py", "data/general_form.py",
    "data/solution.py", "data/network.py",
    "data/presolve/__init__.py", "data/presolve/counters.py",
    "data/presolve/index.py", "data/presolve/queues.py",
    "data/presolve/rules.py", "data/presolve/updates.py",
    "data/scale/__init__.py", "data/scale/equilibrate.py",
    "data/scale/rational.py",
    "providers/__init__.py", "providers/base.py", "providers/column.py",
    "providers/filter.py", "providers/matrix_data.py",
    "exact/__init__.py", "exact/certificate.py", "exact/certify.py",
    "exact/dixon.py", "exact/sensitivity.py",
    "numbers/__init__.py", "numbers/factorize.py", "numbers/rational.py",
    "linalg/__init__.py", "linalg/sparse.py", "linalg/permutation.py",
    "linalg/device.py",
    "simplex/lowering.py", "simplex/result.py", "simplex/host_sparse.py",
    "utils/checkpoint.py", "utils/debug.py",
    "mip/__init__.py", "mip/cuts.py", "mip/branch_bound.py",
)

# (path, line of the copy) pairs allowed to differ from the renamed
# original: docstrings that named a checkout's absolute path.
ALLOWED = frozenset({
    ("exact/certificate.py",
     "(the original solver's src/algorithm/two_phase/tableau/mod.rs:319-357), turned"),
    ("mip/__init__.py",
     "bound (and Gomory cuts) as unimplemented (its README.md:60-70);"),
    ("mip/cuts.py",
     "arithmetic — the original solver's README.md:60-70)."),
    ("mip/branch_bound.py",
     "the original solver's tests/miplib/mod.rs:48-72), and TPU-native by construction:"),
})

# path -> the one top-level function of the copy that is the port's own and
# is left out of the comparison on both sides: the JAX package asks
# jax.default_backend() where the port asks the solve's torch device.
OWN_FUNCTION = {"simplex/host_sparse.py": "should_use_host_sparse"}

# path -> lines of the copy that are the port's own, each present once and
# left out of the comparison: the span each branch-and-bound search records
# in the port's recorder (relp_tpu_torch.utils.logging).
OWN_LINES = {
    "mip/branch_bound.py": ("from relp_tpu_torch.utils.logging import traced",
                            '@traced("bb.search")'),
}


def _without_function(text: str, name: str) -> list:
    """The lines of ``text`` without the top-level function ``name``."""
    lines = text.splitlines()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    start = min([node.lineno] + [d.lineno for d in node.decorator_list]) - 1
    return lines[:start] + lines[node.end_lineno:]


def to_port(text: str) -> str:
    """The rename of the copy: every ``relp_tpu.`` becomes ``relp_tpu_torch.``."""
    return re.sub(r"\brelp_tpu\.", "relp_tpu_torch.", text)


@pytest.mark.parametrize("path", COPIED)
def test_host_module_is_the_renamed_original(path):
    original = to_port((ROOT / "relp_tpu" / path).read_text())
    copy = (ROOT / "relp_tpu_torch" / path).read_text()
    if path in OWN_FUNCTION:
        original = _without_function(original, OWN_FUNCTION[path])
        copy = _without_function(copy, OWN_FUNCTION[path])
    else:
        original, copy = original.splitlines(), copy.splitlines()
    own = OWN_LINES.get(path, ())
    assert all(copy.count(line) == 1 for line in own)
    copy = [line for line in copy if line not in own]
    assert len(copy) == len(original)
    differ = [(i + 1, line) for i, (want, line) in enumerate(zip(original, copy))
              if line != want and (path, line) not in ALLOWED]
    assert differ == []


def test_every_host_module_of_the_port_is_listed():
    """A host module added to the port without its test would not show."""
    port = ROOT / "relp_tpu_torch"
    host_dirs = ("io", "data", "providers", "exact", "numbers", "linalg", "mip")
    found = {str(p.relative_to(port)) for d in host_dirs
             for p in (port / d).rglob("*.py")}
    assert found == {p for p in COPIED if p.split("/")[0] in host_dirs}


_TWINS = {}


def twin(module_name: str, package: str = "relp_tpu_torch"):
    """``module_name`` (a test helper module of the JAX package, or
    ``relp_tpu_torch.testing``) with its imports rewritten to ``package``:
    the same source builds the same inputs from that package's classes."""
    key = (module_name, package)
    if key not in _TWINS:
        origin = importlib.util.find_spec(module_name).origin
        text = pathlib.Path(origin).read_text()
        if package == "relp_tpu_torch":
            text = re.sub(r"\brelp_tpu(?=\.|\s+import\b)", "relp_tpu_torch", text)
        else:
            text = re.sub(r"\brelp_tpu_torch\b", "relp_tpu", text)
        name = f"{module_name}__{package}"
        module = types.ModuleType(name)
        module.__file__ = origin
        sys.modules[name] = module  # dataclasses look their module up
        exec(compile(text, origin, "exec"), module.__dict__)
        _TWINS[key] = module
    return _TWINS[key]


def _package_of(obj) -> str:
    return type(obj).__module__.split(".")[0]


@pytest.mark.parametrize("helper, build", [
    ("tests.test_simplex_small", lambda m: m._gf(
        m.Objective.MINIMIZE, [[1, 2]], [m.RangedConstraintRelation.less()],
        [4], [1, 1], [(0, None), (0, None)])),
    ("tests.test_parallel", lambda m: m._provider(6)[0]),
    ("tests.test_dual", lambda m: m._provider([4, 6])),
    ("tests.test_pipeline_problem1", lambda m: m._problem_2_matrix_data()),
])
def test_twins_build_objects_of_their_own_package(helper, build):
    jax_side = importlib.import_module(helper)
    assert _package_of(build(jax_side)) == "relp_tpu"
    assert _package_of(build(twin(helper))) == "relp_tpu_torch"


def test_the_testing_module_has_a_jax_twin():
    from relp_tpu_torch import testing

    jax_testing = twin("relp_tpu_torch.testing", "relp_tpu")
    assert _package_of(testing.generated_lp(4, 6, 7)) == "relp_tpu_torch"
    assert _package_of(jax_testing.generated_lp(4, 6, 7)) == "relp_tpu"
    assert jax_testing.FAMILIES == testing.FAMILIES

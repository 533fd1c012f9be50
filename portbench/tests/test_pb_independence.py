"""Nothing of the benchmark imports JAX or the JAX package, comparing
top-level module names whole (the port's name begins with the JAX
package's); the reference and the geometry builders import nothing of
the port either, and copy none of its lines."""
import ast
import os

import pytest

import scenes

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "fyp_bidirectionalpathtracer_tpu"}
PORT = "fyp_bidirectionalpathtracer_tpu_torch"


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_levels(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(PORTBENCH)),
                         ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_no_jax(path):
    assert not set(_top_levels(path)) & JAX_NAMES


def test_the_whole_name_is_compared():
    assert PORT.split(".")[0] not in JAX_NAMES
    assert PORT.startswith("fyp_bidirectionalpathtracer_tpu")


# what each folder that feeds or judges the check may import
INDEPENDENT = {"reference": {"__future__", "dataclasses", "math", "torch"},
               "geometry": scenes.BUILDER_IMPORTS}


def _independent_sources():
    for folder in INDEPENDENT:
        yield from _sources(os.path.join(PORTBENCH, folder))


@pytest.mark.parametrize("path", sorted(_independent_sources()),
                         ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_levels(path))
    assert PORT not in names and not names & JAX_NAMES
    assert names <= INDEPENDENT[os.path.relpath(path, PORTBENCH).split(os.sep)[0]]


def test_the_reference_shares_no_source_line_with_the_port():
    """Written from the semantics, not copied: no statement of the
    reference or of a geometry builder longer than a few words appears in
    the port's sources."""
    port = os.path.join(os.path.dirname(PORTBENCH), PORT)
    theirs = set()
    for path in _sources(port):
        theirs |= {line.strip() for line in open(path) if len(line.strip()) > 40}
    ours = [line.strip() for path in _independent_sources()
            for line in open(path) if len(line.strip()) > 40
            and not line.strip().startswith(("#", '"', "'"))]
    shared = [line for line in ours if line in theirs]
    assert len(shared) <= 0.02 * len(ours), shared

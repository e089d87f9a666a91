"""No module of the benchmark imports JAX or the JAX package, and the plain
references and scenes import nothing of the program."""

import ast
import os

from benchmark import common

FORBIDDEN = {"jax", "jaxlib", "flax", "ov2slam_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    base = os.path.join(common.HERE, sub)
    for dp, _, fs in os.walk(base):
        for f in fs:
            if f.endswith(".py") and "_cache" not in dp:
                yield os.path.join(dp, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_the_references_and_scenes_import_nothing_of_the_program():
    paths = list(_modules("reference")) + list(_modules("scenes")) + [
        os.path.join(common.HERE, "peaks.py")]
    for path in paths:
        assert "ov2slam_torch" not in set(_imports(path)), path


def test_the_forbidden_names_are_compared_whole():
    import sys

    sys.modules.setdefault("ov2slam_tpu_like", type(sys)("ov2slam_tpu_like"))
    try:
        assert "ov2slam_tpu" not in common.forbidden_loaded()
    finally:
        del sys.modules["ov2slam_tpu_like"]

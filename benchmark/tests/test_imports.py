"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: ``image_caption_tpu_torch`` is not ``image_caption_tpu``."""

import ast
import os

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")


def imported(path):
    """Top-level names of a file's absolute imports, and whether it makes
    relative imports that leave its folder."""
    tree = ast.parse(open(path).read(), path)
    names, climbs = set(), False
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            elif node.level > 1:
                climbs = True
    return names, climbs


def sources(folder):
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        names, _ = imported(path)
        assert not names & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        names, climbs = imported(path)
        assert "image_caption_tpu_torch" not in names, path
        assert "benchmark" not in names and not climbs, path


def test_the_check_compares_names_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "image_caption_tpu")
    import image_caption_tpu_torch  # noqa: F401
    assert "image_caption_tpu_torch" not in harness.forbidden_modules()

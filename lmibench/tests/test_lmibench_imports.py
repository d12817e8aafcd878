"""What the benchmark imports: never JAX or the JAX package, and in the
reference nothing of the port either.  Top-level names are compared
whole, because the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "learnedmetricindex_tpu", "chip_smoke", "tools"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "learnedmetricindex_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_whole_name_comparison():
    """The check would wrongly pass a prefix match: the port's name starts
    with the JAX package's."""
    assert "learnedmetricindex_tpu_torch".split(".")[0] not in FORBIDDEN
    from lmibench import run
    assert "learnedmetricindex_tpu" in run.FORBIDDEN

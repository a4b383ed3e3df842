"""Nothing under gpubench/ imports JAX or the JAX package, compared as
whole top-level names (``repro_torch`` begins with ``repro``); the plain
references import nothing of the port either."""
import ast

from gpubench.lib.common import (BENCH, FORBIDDEN_IN_REFERENCE,
                                 FORBIDDEN_MODULES, forbidden_loaded)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        forbidden = FORBIDDEN_IN_REFERENCE \
            if "reference" in path.relative_to(BENCH).parts \
            else FORBIDDEN_MODULES
        bad = sorted(set(_imports(path)) & set(forbidden))
        assert not bad, f"{path}: imports {bad}"


def test_the_port_is_not_the_jax_package():
    assert forbidden_loaded(["repro_torch", "repro_torch.models.moe",
                             "torch", "numpy"]) == []
    assert forbidden_loaded(["repro.core", "jaxlib.xla_client", "flax",
                             "repro_torch"]) == ["flax", "jaxlib", "repro"]


def test_the_references_import_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert "repro_torch" not in set(_imports(path)), path

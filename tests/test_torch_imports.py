"""The port stands alone: no module of efficient_llm_inference_tpu_torch,
and neither chip_smoke.py nor the port's scripts, imports jax, transformers
or the JAX package (the machine with the card need not have them). Every
import statement and every importlib.import_module / __import__ call with a
literal name is checked."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "efficient_llm_inference_tpu_torch").rglob("*.py"))
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "transformers", "efficient_llm_inference_tpu")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_the_port_has_files():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported_names(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"

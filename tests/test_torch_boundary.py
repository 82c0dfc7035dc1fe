"""The PyTorch port stands alone: no module of ``src/repro_torch``, no port
example (``examples/torch_*.py``) and not ``chip_smoke.py`` imports ``jax``
(or anything under it) or the JAX package ``repro``, at top level or inside
a function.  Nor ``msgpack`` or
``ml_dtypes``, which the JAX package's checkpoints use and the GPU machine
does not have: the port carries its own MessagePack codec and reads bf16
leaves by name."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "examples" / f"torch_{name}.py"
    for name in ("quickstart", "linear_regression", "serve_batched", "async_gossip")]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_files():
    assert len(PORT_FILES) > 10
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scanner_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.core import flat\n    import jax.numpy\n")
    assert _imported_roots(f) >= {"repro", "jax"}


def test_scanner_catches_the_checkpoint_dependencies(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import msgpack\ndef g():\n    from ml_dtypes import bfloat16\n")
    bad = _imported_roots(f) & set(FORBIDDEN)
    assert bad == {"msgpack", "ml_dtypes"}

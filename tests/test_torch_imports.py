"""Import guard: the port, `chip_smoke.py` and the scripts in `tools/` import
no JAX and nothing of the JAX package (only the tests import both)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = sorted((ROOT / "ark_mpc_tpu_torch").rglob("*.py"))
SCRIPTS = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
FILES = PACKAGE + SCRIPTS


def imported_modules(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_guard_sees_every_module():
    assert len(PACKAGE) > 15 and len(SCRIPTS) > 1
    assert "torch" in imported_modules(ROOT / "chip_smoke.py")
    names = {str(p.relative_to(ROOT / "ark_mpc_tpu_torch")) for p in PACKAGE}
    for module in ("fabric/scheduler.py", "gadgets/bits.py", "gadgets/products.py",
                   "algebra/poly.py", "algebra/domain.py", "ops/matmul.py",
                   "models/circuits.py", "utils/stats.py", "ops/modular32.py",
                   "offline/bgv/powerful.py", "offline/bgv/zkpok_words.py",
                   "offline/errors.py", "offline/structs.py", "offline/lowgear/__init__.py",
                   "offline/lowgear/setup.py", "offline/lowgear/protocols.py",
                   "offline/lowgear/triplets_l.py", "offline/lowgear/core.py",
                   "parallel/step.py", "parallel/launch.py", "parallel/dryrun.py",
                   "parallel/__main__.py", "ops/ntt.py", "ops/pfa.py",
                   "offline/bgv/params.py", "offline/bgv/rns.py", "offline/bgv/bgv.py",
                   "offline/bgv/zkpok.py", "offline/bgv/zkpok_l.py",
                   "offline/lowgear/triplets_bgv.py"):
        assert module in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ark_mpc_tpu"), f"{path}: imports {name}"
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text

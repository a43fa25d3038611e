"""The PyTorch port stands alone: it imports neither JAX nor flax nor any
module of the JAX package, and neither does ``chip_smoke.py``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sic_tpu_torch"
FORBIDDEN = ("jax", "flax", "sic_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _source_id(path: Path) -> str:
    """The file's name; a module of ``retrieval/`` or ``service/``, and the
    search and build CLIs, with their package too, since
    ``retrieval/codec.py`` repeats ``models/codec.py``'s name and
    ``cli/build.py`` ``cpp/build.py``'s."""
    rel = path.relative_to(ROOT).parts
    qualified = rel[:2] in (("sic_tpu_torch", "retrieval"), ("sic_tpu_torch", "service")) \
        or rel[1:] in (("cli", "build.py"), ("cli", "search.py"))
    return "/".join(rel[1:]) if qualified else path.name


@pytest.mark.parametrize("path", _port_sources(), ids=_source_id)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax and flax
    cannot be imported, and pulls in no module of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import sic_tpu_torch\n"
        "for m in pkgutil.walk_packages(sic_tpu_torch.__path__, 'sic_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'sic_tpu' or m.startswith('sic_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device, and alone in a directory without the repo,
    chip_smoke.py exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout

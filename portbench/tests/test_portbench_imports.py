"""Nothing the benchmark runs imports JAX, flax or the JAX package, and
the reference imports nothing of the program either: top-level module
names compared whole (``sic_tpu_torch`` begins with ``sic_tpu``)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "sic_tpu"}

PROBE = """
import json, sys, importlib, pkgutil
sys.path.insert(0, {root!r})
import portbench.{pkg} as pkg
for m in pkgutil.iter_modules(pkg.__path__):
    importlib.import_module("portbench.{pkg}." + m.name)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(pkg: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), pkg=pkg)],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    names = _top_level("reference")
    assert not names & (FORBIDDEN | {"sic_tpu_torch"}), names & (FORBIDDEN | {"sic_tpu_torch"})


def test_harness_and_drivers_import_no_jax():
    for pkg in ("harness", "drivers"):
        names = _top_level(pkg)
        assert not names & FORBIDDEN, (pkg, names & FORBIDDEN)


def test_a_run_loads_no_jax():
    """The run's own guard: a tiny run of each mix prints a result, which
    it does only when no forbidden module is loaded after the window."""
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
             "from portbench.tests._util import run_cell;"
             "r = run_cell('titok.generate');"
             "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=600, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & FORBIDDEN


def test_a_check_that_loads_jax_gives_no_result(monkeypatch, capsys):
    """The guard runs again once the reference has run: a check that pulls
    in a forbidden module ends the run with code 3 and no result line."""
    import types

    import pytest

    from portbench.drivers import generate
    from portbench.harness import core
    orig = generate.Driver.check

    def check(self):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(self)
    monkeypatch.setattr(generate.Driver, "check", check)
    with pytest.raises(SystemExit) as exit_:
        core.main(["--workload", "titok.generate", "--seed", "3000000017",
                   "--seconds", "1", "--trace", "0", "--cpu-tiny"], 0.0)
    assert exit_.value.code == 3
    out = capsys.readouterr()
    assert not out.out.strip() and "jax" in out.err

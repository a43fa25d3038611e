"""Each traffic mix runs once on the CPU at its configuration's tiny
preset for a second and prints a well-formed last line."""
import pytest

from ._util import run_cell


def _well_formed(r, trace):
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if not trace:
        assert "setup_s" in r["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])


@pytest.mark.parametrize("workload", ["flagship.decompress", "titok.generate",
                                      "flagship.compress"])
def test_tiny_run(workload):
    _well_formed(run_cell(workload), 0)


def test_tiny_traced_run():
    _well_formed(run_cell("titok.generate", trace=1), 1)

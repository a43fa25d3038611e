"""A cell, a traffic mix and a per-layer metric added as new files and
entries alone, in a copy of the benchmark, are found and run."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "sic_tpu_torch", tmp_path / "sic_tpu_torch")
    mix = json.loads((ROOT / "portbench/traffic/generate.json").read_text())
    mix["batch"] = 3
    (tmp_path / "portbench/traffic/generate_small.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/images_seen.py").write_text(
        "def read(run):\n    return float(run.images) if run.images else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "titok.generate_small", "config": "titok-l32-maskgit",
                               "traffic": "generate_small", "chips": 1,
                               "why": "three labels a batch"})
    bench["per_layer"].append({"name": "images_seen", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "img_per_s", "workloads": ["titok.generate_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "titok.generate_small",
         "--seed", "3000000013", "--seconds", "1", "--trace", "1", "--cpu-tiny"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["attempted"] % 3 == 0
    assert r["metrics"]["images_seen"]["value"] == r["attempted"]


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files a run fails and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "titok.generate",
         "--seed", "3000000013", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert not out.stdout.strip()

"""On the card: each cell's control (the precision below the one its
configuration states: the program's int8 path for the bf16 codec, the
reference in TF32 for the fp32 generator) fails one of the cell's limits,
on three seeds at the cell's own size, while the program passes them all.
Skips without a card; run on the card with
``python3 -m pytest -m gpu portbench/tests/test_portbench_controls.py``."""
import argparse
import importlib
import time

import pytest

CELLS = ["flagship.decompress", "titok.generate", "flagship.compress"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_program_passes(card, workload):
    from portbench.harness import core
    bench = core.load_benchmark()
    cell, config, traffic = core.find_cell(bench, workload)
    core.prepare_environment()
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    limits = traffic["limits"]
    for seed in (3000000901, 3000000902, 3000000903):
        run = core.Run(argparse.Namespace(seed=seed, seconds=3.0, trace=0, cpu_tiny=False),
                       cell, config, traffic, card)
        drv = driver.Driver(run)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3.0:
            drv.step()
        drv.release()
        program = drv.check()
        control = drv.control_check()
        assert all(program[k] <= limits[k] for k in limits), (seed, program)
        assert any(control[k] > limits[k] for k in limits), (seed, control)

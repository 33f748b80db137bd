"""The control: the reference put in the program's place, in fp8, one
step below the configurations' bf16. On the card at the cells' own size
it has to fail the committed limits on three seeds; on the CPU at a
small size it reads far above a sound float32 run."""

from __future__ import annotations

import pytest
import torch

from h100bench import calibrate, cells, run
from h100bench.conftest import PAIRS, tiny_cell

CELLS = ["mnv2.b8_saturated", "ssd.b1_saturated"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_a_sound_run(name, cpu_device):
    cell = tiny_cell(*PAIRS[name])
    for seed in (11, 12, 13):
        sound = run.run_cell(cell, seed, 0.5, False, device="cpu")["checks"]
        control = calibrate.control_numbers(cell, seed, device="cpu")
        assert any(control[k] > 10 * max(sound[k]["value"], 1e-5)
                   for k in control), (sound, control)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.fix_caches()
    config, traffic = PAIRS[name]
    cell = cells.Cell(name=name, chips=1, traffic_name=traffic,
                      traffic=cells.load_traffic(traffic),
                      config=cells.load_config({
                          "name": config,
                          "file": f"h100bench/configs/{config}.json"}))
    limits = cell.config.data["limits"]
    for seed in (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503):
        got = calibrate.control_numbers(cell, seed)
        assert any(v > limits[k] for k, v in got.items()), got

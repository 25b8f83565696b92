"""On the card: the control at each configuration's own size, on three
seeds, fails a limit of its configuration (the CPU tests hold it at a
toy size). Run with ``python3 -m pytest gpubench/tests`` on a machine
with the card; skipped without one."""

from __future__ import annotations

import pytest

from gpubench.harness import spec

CELLS = [w["name"] for w in
         spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    import torch

    from gpubench.tools import control

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(name)
    limits = cell.config["check"]["limits"]
    for seed in (4_700_000_001, 4_700_000_002, 4_700_000_003):
        numbers, summary = control.readings(
            cell, seed, 4, cell.config["check"]["frames"], card)
        assert summary["frames"] == cell.config["check"]["frames"]
        assert any(numbers[k] > limits[k] for k in limits), numbers

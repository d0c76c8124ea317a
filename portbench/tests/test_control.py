"""The control at a size a CPU test holds: the reference in bfloat16 in the
program's place fails the cell's limits on the same states where the
program passes them (portbench/control.py; on the card it runs at each
cell's own size)."""

from __future__ import annotations

import pytest
import torch

from test_faults import limits


@pytest.mark.parametrize("cell,traffic,config_edits,traffic_edits", [
    ("1li2-md", "md_strict40", dict(neighbor_every=4),
     dict(check_extra_windows=0)),
    ("1li2-score16", "score16_closed", None,
     dict(poses_per_call=4, check_calls=1, slice_calls=1)),
])
def test_the_control_fails_where_the_program_passes(
        checkout, monkeypatch, cell, traffic, config_edits, traffic_edits):
    import control
    import harness

    lim = limits(cell)
    checkout.add_cell("t-" + cell, "1li2", traffic, lim, config_edits,
                      traffic_edits)
    monkeypatch.setattr(harness, "HERE", checkout.bench)
    monkeypatch.setattr(harness, "ROOT", checkout.root)
    [(_, prog, ctrl)] = control.readings("t-" + cell, [11], 0.2,
                                         device=torch.device("cpu"))
    assert all(prog[k] <= v for k, v in lim.items()), prog
    assert any(ctrl[k] > v for k, v in lim.items()), ctrl

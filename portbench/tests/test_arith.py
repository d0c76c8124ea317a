"""The traced run's arithmetic on synthetic device records, and the
roofline's live-pair count against brute force."""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

import harness
import roofline
import spans

# (name, start ns, end ns): two overlapping pair sweeps, a copy, and an
# elementwise kernel after two idle gaps
OPS = [("born_subtiles_kernel", 0, 1000), ("gb_subtiles_kernel", 500, 2000),
       ("Memcpy HtoD (Pageable -> Device)", 3000, 3100),
       ("vectorized_elementwise_kernel", 5000, 6000)]
HOST = [("slice", 0, 7000), ("run_md", 0, 7000),
        ("window_build", 1900, 3050)]


def metric(name, data):
    return harness.load_module("metrics", name + ".py").read(data)


def test_busy_gaps_and_top_ops():
    assert spans.busy_intervals(OPS) == [[0, 2000], [3000, 3100],
                                         [5000, 6000]]
    assert spans.busy_seconds(OPS) == pytest.approx(3.1e-6)
    assert spans.idle_gaps(OPS, HOST) == [["run_md", pytest.approx(1.9e-6)],
                                          ["window_build",
                                           pytest.approx(1.0e-6)]]
    top = spans.top_ops(OPS, 2)
    assert top[0] == ["gb_subtiles_kernel", pytest.approx(1.5e-6)]
    assert top[1][1] == pytest.approx(1.0e-6)


def test_per_layer_readers_on_synthetic_records():
    md = dict(kind="md", device_ops=OPS, busy_s=3.1e-6, slice_units=2,
              timed_s=1e-3, units=100, pair_least_s=1e-6, regrows=3,
              build_ms=[5.0, 1.0, 9.0])
    assert metric("step.kernels_per_step", md) == 1.5
    assert metric("kernels.pair_roofline_pct.md", md) == pytest.approx(40.0)
    assert metric("device.idle_pct.md", md) == pytest.approx(84.5)
    assert metric("md.regrows", md) == 3
    assert metric("window.build_ms", md) == 5.0
    score = dict(md, kind="score")
    assert metric("score.device_ms_per_pose", score) == pytest.approx(
        1.55e-3)
    assert metric("kernels.pair_roofline_pct.score", score) == \
        pytest.approx(40.0)
    # a reader finds nothing in another kind's cell or without a trace
    for name in ("step.kernels_per_step", "kernels.pair_roofline_pct.md",
                 "device.idle_pct.md", "md.regrows", "window.build_ms"):
        assert metric(name, score) is None
    for name in ("score.device_ms_per_pose", "device.idle_pct.score",
                 "kernels.pair_roofline_pct.score"):
        assert metric(name, md) is None
    assert metric("kernels.pair_roofline_pct.md",
                  dict(md, device_ops=OPS[2:])) is None
    assert metric("window.build_ms", dict(md, build_ms=[])) is None


def test_live_pairs_against_brute_force():
    from openmm_agbnp_plugin_tpu_torch.io.gaussvol_dat import \
        load_gaussvol_dat

    pos, _, _, _, _, ish = load_gaussvol_dat(
        os.path.join(ROOT, "tests", "fixtures", "gaussvol.dat"))
    pos = np.asarray(pos)
    heavy = np.asarray(ish) == 0
    for horizon, cutoff in ((1.0, 1.0), (2.0, 1.0), (0.6, None)):
        nd = nb = ng = 0
        for i, j in itertools.permutations(range(len(pos)), 2):
            d = math.dist(pos[i], pos[j])
            nb += d < horizon and heavy[j]
            if i < j:
                gb = cutoff is None or d < cutoff
                ng += gb
                nd += gb or (d < horizon and (heavy[i] or heavy[j]))
        got = roofline.live_pairs(torch.as_tensor(pos), torch.as_tensor(heavy),
                                  horizon, cutoff, block=100)
        assert got == (nd, nb, ng)
        flops, nbytes = roofline.pair_work(torch.as_tensor(pos)[None],
                                           torch.as_tensor(heavy), horizon,
                                           cutoff, 1000)
        assert flops == 9 * nd + 55 * nb + 37 * ng
        assert nbytes == 68 * len(pos) + 1000
    assert roofline.least_seconds(67e12, 0) == 1.0
    assert roofline.least_seconds(0, 3.35e12) == 1.0

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from openmm_agbnp_plugin_tpu_torch/csrc, then:

  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. holds each kernel against its plain PyTorch twin on the card, in f32,
     and times both: the dense-grid sweeps at the 1li2 shapes (NP 1536,
     NHP 768, E 24; horizon and cutoff 1 nm, with and without the fused MM
     terms; the GB sweep, the list kernel over every tile pair, also with
     both boxes and launched twice, also without a cutoff and at 2clr's
     dense shapes, with an empty kernel's launch time beside its bound;
     the chunk list, bitwise its twin, and over it the Born sweep, the
     reloading descreening on its chunk-layout Q/dQ and the recomputing
     one, and the Born sweep given no list, whose own list is bitwise the
     twin's and whose results are bitwise the given list's, at horizons 1
     and 2 nm, with no box and both boxes, each launched twice, at 1li2's
     and 2clr's dense shapes), the
     interacting-tile-list sweeps at
     1li2's list shapes (T 256; also with an orthorhombic and a triclinic
     box) and at 2clr's (NP 6144, NHP 3328, E 24; Born and descreening
     lists at
     horizons 1 and 2 nm, the reload from the Born kernel's Q/dQ and keep
     bits and from the twin's Q/dQ, the GB list with and without MM; the
     Born kernel's Q/dQ checked on the sub-tile pairs its keep bits name
     and the bits against subtile_live; the list kernels and the dense
     reload launched twice and held bitwise equal); the list kernels are
     timed at the budgets the model gives its lists, the dense recomputing
     descreening at 1li2's and 2clr's shapes; beside each time, the
     kernel's bound from this run's live pairs and bytes (the Born sweeps'
     Q/dQ at 8 bytes a live pair, the bytes of their dense layout and of
     the kept sub-tile pairs or chunk slots they write or read reported
     beside; the dense Born sweep timed as the main path runs it, building
     its own chunk list, and also walking a given one), and in the log,
     for the kernels redesigned last,
     their times before the redesign; then the two row kernels (take_rows, cumsum_rows) at
     the row probe's default shape (85,504 rows x 8 from 34,816 parents)
     and at the widest level of 2clr's overlap tree: take_rows bitwise
     equal to its twin (also with unsorted and out-of-range ids) at every
     width the tree's passes give it (1, 6, 12, 13 and 26 columns, parent
     and atom ids, a table at an odd word address), cumsum_rows launched
     twice (bitwise), within 1e-5 of an f64 prefix sum and no further from
     its twin than the twin from f64, the gather-free broadcast's
     deviation from the gather, and both timed beside torch.index_select
     and torch.cumsum (library_ms), take_rows at each tree width and at
     the padded widths 16 and 28; then the replica axis of every pair
     kernel at 1li2's shapes (dense and lists, three boxes, both
     horizons) and 2clr's lists: a batch of 3 replicas (displaced 0.01 nm,
     numpy seed) in one launch, counted once, bitwise each replica's own
     B = 1 launch, and the batched tile lists bitwise each replica's own;
  3. checks the fixture goldens through AGBNPModel on the card in f32
     (GVolSA 872.514, AGBNP1 -2476.66, within 0.01);
  4. checks the five shipped systems (trpcage, 1li2, rnaseh, 1dwc, 2clr;
     AGBNP1, no cutoff, 2 nm horizon; rnaseh with half_neighbor_pairs tree
     candidates on the device, 1dwc and 2clr through the cell grid, on the
     Born/descreening lists) against the stored f64 results of the JAX
     package (benchmarks/.parity_cache), then 2clr with Q/dQ sharing off against
     sharing on, on the list route and on the dense route;
  5. checks that two evaluations of 1li2, and of 2clr, are bitwise equal;
  6. runs the port's Simulation on 1li2 on the dense grid (f32, 200
     Langevin steps at 1 fs, neighbor list and tree topology rebuilt every
     40 steps, the vdW-compact WU pass: bench.py's strict run on the dense
     route) and checks that every energy is finite, no capacity overflow
     remains, and every dense kernel launched at least once per step and
     the tree kernels at every level of both passes of every step;
  7. runs 2clr MD on the tile lists with the cell-grid neighbor build
     (200 timed steps after a 200-step warm-up) with the same checks for
     the list kernels; like 6, 8 and 9 at the lean tree capacities the
     Simulation sizes from its positions (caps_boost 1.10);
  8. bench.py's headline configuration on 1li2 (mts_wu4: the WU pass as
     an r-RESPA impulse every 4 steps, vdW-compact, tile lists): the
     compacted WU force against the full pass at a window start, a window
     of k=1 impulse steps against the plain fused step, then 200 timed
     steps after an equal warm-up with the checks of 6-7;
  9. bench.py's mts4fs_constraints configuration on 1li2 (4 fs outer
     step, 2 bonded substeps, SHAKE/RATTLE, rebuilds every 10 outer
     steps): 100 timed outer steps after an equal warm-up, the SHAKE
     residual channel clean and the final constraint violation within the
     float32 floor 3.6e-6; a replayed outer step's device ms and its
     parts' (the slow and fast classes, SHAKE, RATTLE, each captured and
     replayed alone); then run_md of 100 outer steps, eager and graphed
     in turns as 34's (eager, graph, graph, eager): ms an outer step,
     md.graph_step_pct, every turn bitwise the first;
 10. checks that SHAKE, RATTLE and the WU compaction make no host sync
     (torch.cuda.set_sync_debug_mode("error"));
 11. checks that run_md resumed from its step-40 checkpoint reproduces the
     uninterrupted 80-step trajectory bitwise;
 12. drives the AGBNPForce/Context entry point on the card in f32: the
     fixture goldens, getEnergy against getEnergyForces, a parameter edit
     through updateParametersInContext against a fresh Context, a
     CutoffPeriodic Context in a 20 nm box against CutoffNonPeriodic, and
     1li2 at full width (NoCutoff, the dense kernels) against AGBNPModel
     and the stored f64 result;
 13. runs the row probe (profile_port_step.py --row-probes), the path of
     cumsum_rows, and counts the row kernels' launches;
 14. AGBNP2 (version 2) and version 0 MD: the V2 anchor on the fixture's
     first 40 atoms in f64 (plain phases) and in f32 (PairCavity over the
     dense kernels #1-#3, each launched once); 1li2 in f32 against the
     port's f64 on the card, at the f64 model's capacities grown until
     nothing overflows; Simulation(version=2) on 1li2 (f32, 1 nm GB
     cutoff, one build a 40-step window, a first window for the
     PanicButton, then 100 timed Langevin steps after an equal warm-up; no
     overflow, #1-#3 launched every step, never the recompute);
     Simulation(version=0) on 1li2 for 20 steps; and the v2 Context on
     the card (the anchor, getEnergy; 1li2, where its PanicButton grows
     the MS-tree neighbor width);
 15. replicas as a batch (parallel/ensemble.py): one batched evaluation of
     8 jittered 1li2 conformers (0.01 nm, numpy seed; tile lists) against
     each conformer's B = 1 evaluation (energy 1e-6 relative, forces 1e-5
     of max|f|, each list kernel launched once); then ReplicaEnsemble on
     1li2 (strict 1 fs Langevin, 300 K, 1/ps, rebuilds every 40 steps,
     vdW-compact WU pass), R = 1 and R = 8 in turns through the same
     runner (40 warm-up and 100 timed steps, then 100 timed again): ms/step,
     ns/day per replica and aggregate, no overflow, finite energies that
     differ across replicas, the list kernels every step; kernels and
     device ms a step of a profiled window at R = 1 and R = 8;
 16. ReplicaEnsemble of 4 x 2clr (BASELINE config 5: the cell grid per
     replica, tile lists), 80 timed steps after 40, and the peak device
     memory of a window build;
 17. TemperatureREMD of 8 x 1li2 on geometric_ladder(300, 450, 8), 40
     steps a cycle and a window, 2 warm-up cycles then 5: rungs a
     permutation each cycle, acceptances in [0, 1], ns/day per replica;
     then an all-300 K ladder of 2 replicas, two cycles of 10 steps,
     bitwise ReplicaEnsemble with the same generators;
 18. ConformerScorer on 1li2: 16 poses (0.01 nm, numpy seed), NoCutoff
     (the dense sweeps) and CutoffNonPeriodic 1 nm (the lists), against
     the Context one pose at a time (energy 1e-5 relative, forces 1e-5 of
     max|f|), the kernels and device ms of a score call at B = 1 and
     B = 16 (each pair kernel once a call); refine of 4 poses (50 FIRE
     iterations) lowers every energy; version 2 on 2 poses of the 264-atom
     fixture against the v2 Context.
 19. ParameterGradients on 1li2 (full width, NoCutoff, pair_kernel=False)
     in f64 and f32: 4 poses jittered 0.005 nm (numpy seed), gamma, alpha
     and charge gradients against central finite differences along a
     random direction (JAX's bar, rtol 5e-6, atol 1e-8), the hydrogens'
     gamma gradients exactly 0, f32 within 1e-4 of max|g| of f64, the
     tree's take_rows launched in the forward, the backward (TakeRows'
     segment sums) under set_sync_debug_mode("error"), ms a call;
 20. ReplicaEnsemble of 1li2 with its 665 X-H constraints (SHAKE/RATTLE
     per replica, strict 1 fs, lists, 40-step windows), R = 1 and R = 8 in
     turns (40 warm-up and 80 timed steps): every replica's violation and
     SHAKE residual within the f32 tolerance, replica 0 of R = 8 within
     1e-5 in energy of the R = 1 run from the same state and generator at
     every step, the list kernels every step; then TemperatureREMD with
     constraints, 2 cycles of 40 on geometric_ladder(300, 450, 8);
 21. the per-step path: ReplicaEnsemble.make_runner(neighbor_every=0) on
     4 x 1li2, 20 steps, its first step against the windowed runner's;
     then a 20-step window of 4 trp-cage replicas with two hydration sites
     sharing a parent: sites exactly at w1 p1 + w2 p2, site forces 0;
 22. the Simulation options: 1li2 with pair_kernel=False in f64 against
     the f32 kernel route (energy and forces 1e-5), then 40 MD steps after
     an equal warm-up; include_mm=False against the model's energy (1e-6);
     make_langevin_runner(topology_relax=0.5): a 40-step window with no
     overflow (regrown if the birth-margin rows need room), its first step
     against relax=None's (1e-5).
 23. the batched AGBNP2 evaluation in ConformerScorer version 2 on 1li2
     (f32, NoCutoff): 8 poses (0.005 nm, numpy seed) in one call, #1-#3
     launched once with the replica axis, each pose against its own
     B = 1 score (1e-6 / 1e-5) and against the port's f64 scorer on the
     card (1e-5 / 1e-4), the kernels and device ms of a call at B = 1 and
     8, the peak memory of the B = 8 call;
 24. version 2 on the replicas' per-step path: ReplicaEnsemble of 1li2,
     make_runner(neighbor_every=0), R = 1 and R = 4 fed the same noise, 2
     warm-up and 10 timed steps: replica 0 of R = 4 within 1e-5 in energy
     of R = 1 at every step, ms/step, #1-#3 every step; the windowed
     runner and T-REMD refuse version 2;
 25. bench.py's synth10k leg: utils/synthetic.py's run_md(10240,
     nsteps=160) on the bonded synthetic ball (AGBNP1 + the MM force
     field, CutoffNonPeriodic 1 nm, f32, the cell grid and tile lists,
     rebuilds every 20 steps) through the reference's windowed protocol:
     4 heat windows from 300 K, shrink-to-fit if they regrew, 4 timed
     windows (bench.py's 400 steps blow up near step 200: SYNTH_STEPS),
     every overflowed window regrown and retried from its start:
     finite energies, no overflow left, #5-#7 once a step run and
     the tree kernels at every level, the clean windows' median ms/step and
     ns/day, regrows by channel, each window's kinetic temperature; one
     evaluation at the final positions against the port's f64
     pair_kernel=False route on the card (1e-5 / 1e-4).  Phase 14 also
     logs the peak memory of a
     version 2 window build (the MS tree's half list in row blocks).
26. the native f64 engine (runtime/native.py, built with the host's
     make/g++ into the package's _build/): AGBNP1 on the 264-atom fixture
     against the goldens (-2476.66, E_cav 872.514, the displacement check
     0.0874992 / 0.0886249), then 1li2 in f32 on the dense sweeps (#1-#3)
     on the card against the native f64 result (1e-5 / 1e-5);
 27. the port's four examples through their main() on the card: test_agbnp
     (AGBNP_TEST_* step counts: 20 FIRE, 200 Langevin, 100 Verlet),
     rescore_conformers (64 poses, 5 reps), remd_trpcage (2 cycles of 40)
     and multichip_md (20 steps over 2 ranks sharing the card): each
     returns 0 and prints finite energies;
 28. sharding over torch.distributed on the card (parallel/sharding.py,
     ranks started by run_ranks, gloo: the ranks share cuda:0): trp-cage
     v1 f64 MD over a 2-rank atoms mesh, 12 steps in windows of 6, against
     the unsharded runner on the card at the JAX test's tolerances (rtol
     1e-12 / atol 1e-9 in energy, 1e-12 nm in positions), the ranks
     bitwise equal, take_rows on the row blocks; ms/step of the plain
     runner, a 1-rank and the 2-rank mesh over 60 more steps; then a
     2-rank replica mesh: ReplicaEnsemble 4 x trp-cage (20 steps) and
     ConformerScorer 8 poses against one process (bitwise or within
     1e-5 / 1e-4 nm and 1e-6 / 1e-5);
29. mixed=True (f32 pair math, f64 sums, the plain route) on 1li2: f32
     mixed, f32 plain and f64 plain over the DMS pose and 31 poses
     jittered 0.02 nm (numpy seed), at NoCutoff and at 1 nm with the
     horizon at the cutoff: each mode's energy error and max|df|/max|f|
     against f64, the mean energy error of mixed below plain f32's, every
     error within 1e-5; Langevin MD of the mixed Simulation, the f64 plain
     route of [22] and the f32 dense kernels of [6] in turns (40 timed
     steps after 40 each, rebuilds every 40), ms/step each;
     ConformerScorer(mixed=True) on 16 poses, each against its own B = 1
     score (1e-6 / 1e-5); the refusals (pair_kernel=True, version 2, an
     atoms mesh); no pair kernel launched, take_rows (#8) launched;
30. the port's f64 NumPy oracles on this host (no JAX): their goldens
     (872.514 with 2287.78 / -1415.27, -2476.66, the displacement check
     0.0874992 / 0.0886249, the v2 anchors on the fixture's first 40
     atoms) and their host seconds; then the card against them on all 264
     atoms: f32 v1 and v2 through #1-#3 on the dense grid (energy 1e-5,
     v1 forces 1e-4 of max|f|), f64 v1 and v2 on the plain route (energy
     1e-9).
31. large N (the JAX package's large-system path): (a) the overlap tree
     of 1li2, 2clr and the synthetic ball at 10,240 and 16,384 atoms
     (AGBNPModel f32, cutoff 1 nm, sized from the positions) built one-shot
     and chunked (ops/tree.py's dispatch thresholds forced), levels and
     diag bitwise equal, each build's ms and peak memory, the chunked peak
     below the one-shot's; (b) utils/synthetic.py's run_md at 16,384 atoms
     (20-step windows, tile lists, the cell grid, the windowed protocol of
     [25] over 120 steps: 4 heat and 2 timed windows): no overflow left,
     finite energies, #5-#7 every step run (#7 recomputing where the
     lists' Q/dQ exceed QD_BYTES_LIMIT), the tree kernels at every level;
     (c) synthetic.run at
     24,576 atoms (5 timed evaluations): whether Q/dQ is shared, one
     evaluation with share_qd=False (#7 recomputing) against one with the
     lists' Q/dQ shared (#7 reloading; QD_BYTES_LIMIT raised to their
     bytes for that evaluation alone) and the model's own (1e-5), the f32
     evaluation against the native f64 engine on the card's host (energy
     1e-5, forces 1e-4 of max|f|), its tree built chunked (and one-shot
     when the 16,384-atom build's bytes a candidate say it fits), and
     #5-#8 again on the inputs that evaluation gave them, against their
     twins and timed beside their bounds.
32. GaussVol's free volumes on the card: ops/tree.py's
     reduce_tree(with_freevol=True) in f32 on 1li2's overlap tree as the
     model builds it (large radii, the model's capacities) against the
     native f64 engine's free_volume and volume on the host (1e-5 of
     max|free_volume|, 1e-5 relative), over the fixed-topology rescan of
     its volumes, twice bitwise; take_rows at every level of each rescan.
33. the fixed-topology tree passes as per-level kernels (csrc/tree.cu) at
     the MD cells' topologies (1li2, 2clr, 4 x 2clr; f32, a window build
     at the MD capacities): the step's cavity and WU passes on the route
     against the torch twin and the f64 twin (TREE_F32_BARS: 1e-5, the
     cavity force 3e-5), twice bitwise; each kernel's device ms a launch
     (CUDA events around each launch, the stream held behind a sleep)
     beside its bytes bound and the two passes' ms on the route and on the
     twin; MD ms a step on the route and on the twin (window builds
     without the kernels' prep) in turns in one process, the tree
     kernels' launches and tree.kernel counters a step.

34. a runner's CUDA graphs, kept across its rebuild windows
     (md/graphs.py): 1li2 and 2clr MD (run_md's runner), 4 x 2clr
     replicas (ReplicaEnsemble), 1li2 in AGBNP2 (run_md's runner,
     window_v2) and 1li2 with the WU impulse every 4 steps (wu4: two
     graphs, replayed in turns), each a warm-up window (the graphed
     turns' first capturing) then GRAPH_STEPS timed steps, eager
     (capturable declined) and graphed in turns (eager, graph, graph,
     eager) in one process: wall and CUDA-event ms a step, the replayed
     steps (all of a graphed turn's), every turn's trajectory, energies
     and diagnostics bitwise the first's and its launch tallies equal;
     then 1li2 and 1li2 wu4 over GRAPH_KEEP_WINDOWS windows from a fresh
     runner, graphs kept against captured anew every window, in turns:
     ms a step, captures and reuses counted, bitwise; a 1li2 window step
     of AGBNP1 and of AGBNP2 run eagerly and captured and replayed under
     set_sync_debug_mode("error").

    python3 chip_smoke.py --only N      (N = 9, 25, 31, 32, 33 or 34)

builds the kernels and runs phase N alone.

Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits non-zero before doing anything.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is nvidia-smi's
name/power-limit line, and the one before that the per-kernel JSON record
(times, bound and what sets it, library_ms null for the pair sweeps and
measured for the row kernels, live pairs, launches on its path and per step
of each MD phase [6]-[9], [14] and of the replica runs [15]-[17], in
one batched score of [18] and on each of [19]-[22], [23]-[25],
[26]-[28], [29]-[30], [31] and [32], and the list kernels' and take_rows'
times at [31]'s 24,576-atom shapes; for the Born and descreening sweeps
also the kept
32x32 sub-tile pairs or the chunk slots and the Q/dQ bytes written or read).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAIRS_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/pairs.cu"
TILES_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/tiles.cu"
ROWS_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/rows.cu"
TREE_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/tree.cu"
TPU = "openmm_agbnp_plugin_tpu/ops/pallas/pairs.py"
TPU_PROBE = "benchmarks/micro_pallas_gather.py"
# name -> (source, TPU kernel it replaces, the phase whose launches count)
# (the chunk list subtile_columns is the H100 design's own work list for
# born_sums and the dense descreening, which walk it: it replaces no TPU
# kernel; on the main path the Born kernel builds its list itself, and the
# standalone kernel launches for the recompute with sharing off; the tree
# kernels replace no TPU kernel either: the JAX package's tree passes are
# plain jnp; an MD window's passes run the tree kernels, and take_rows moves
# the rows of the torch passes, as AGBNP2's MD runs them)
KERNELS = {
    "subtile_columns": (PAIRS_SRC, None, "share_off"),
    "born_sums": (PAIRS_SRC, f"{TPU}:420", "md_1li2"),
    "gb_pair": (TILES_SRC, f"{TPU}:569", "md_1li2"),
    "descreening": (PAIRS_SRC, f"{TPU}:740", "md_1li2"),
    "descreening_recompute": (PAIRS_SRC, f"{TPU}:740", "share_off"),
    "born_sums_tiles": (TILES_SRC, f"{TPU}:842", "md_2clr"),
    "gb_pair_tiles": (TILES_SRC, f"{TPU}:966", "md_2clr"),
    "descreening_tiles": (TILES_SRC, f"{TPU}:1114", "md_2clr"),
    "descreening_tiles_recompute": (TILES_SRC, f"{TPU}:1114", "share_off"),
    "take_rows": (ROWS_SRC, f"{TPU_PROBE}:99", "md_v2"),
    "cumsum_rows": (ROWS_SRC, f"{TPU_PROBE}:145", "row_probes"),
    "tree_rescan": (TREE_SRC, None, "md_1li2"),
    "tree_reduce": (TREE_SRC, None, "md_1li2"),
    "tree_deposit": (TREE_SRC, None, "md_1li2"),
}
# the row probe's default shape (benchmarks/micro_pallas_gather.py:64-66) and
# the repetitions of its run as a path of this script
PROBE_ROWS, PROBE_PARENTS, PROBE_REPS = 85504, 34816, 20
KERNEL_TOL = 1e-5     # max|kernel - twin| / max|twin|, f32 summation order
# FP32 operations per live pair, counted from the twins' formulas (each +,
# -, *, /, sqrt and exp one): distance 9, spline Q and dQ/dd 35, the Born
# sum 2, the GB pair 37 (+28 with the fused LJ/Coulomb), a descreening
# pair 18; the chunk list's test of a column against a sub-tile's box 11
OPS_PER_PAIR = dict(born=46, gb=46, gb_mm=74, descreen=27, descreen_spline=62,
                    chunk_test=11)
PEAK_FP32 = 67e12     # FLOP/s, H100 SXM data sheet, FP32 outside tensor cores
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3
LIBRARY_NONE = ("none: no PyTorch call computes the sweep (a spline lookup, "
                "an exclusion scan and a deterministic row/column deposit)")
# device ms of the dense GB sweep (one warp a row over the full square),
# the Born list sweep, the dense Born sweep (one warp a row), the dense
# reloading descreening (the list kernel over every tile pair), the dense
# recomputing one (row pass, column pass, reduce) and the row prefix sum
# (two passes over tiles of 33-row segments) before their redesign, by
# (kernel, shapes) as timed in [2] (PERF.md's kernel table: NVIDIA H100
# 80GB HBM3, 700 W); for the log only
BEFORE_MS = {("gb_pair", "1li2"): 0.0418,
             ("born_sums_tiles", "2clr"): 0.1075,
             ("born_sums_tiles", "1li2"): 0.0722,
             ("born_sums", "1li2"): 0.0185,
             ("descreening", "1li2"): 0.0148,
             ("descreening_recompute", "2clr"): 0.1341,
             ("cumsum_rows", "probe"): 0.0126}
# the widths of the tables the tree's passes gather rows from, with the ids
# they take (ops/tree.py): the per-atom gamma, the atomic rows of one and of
# two parameterizations, a level's packed rows of one and of two, the
# running gamma sums of the level above
TREE_WIDTHS = ((1, "atom"), (6, "atom"), (12, "atom"), (1, "parent"),
               (13, "parent"), (26, "parent"))
# what padding the packed level rows to whole 16-byte pieces would gather
PADDED_WIDTHS = ((16, "parent"), (28, "parent"))
# the tree's row gathers at each level of a pass: the parent rows and the
# atom rows
GATHERS_PER_LEVEL = 2
# bytes of Q and dQ in one 32x32 sub-tile pair, and in one slot of a chunk
QD_SUBTILE_BYTES = 2 * 32 * 32 * 4
QD_SLOT_BYTES = 2 * 4
# keys of a kernel's record beyond the contract's, copied into the JSON line
RECORD_EXTRAS = ("kept_subtile_pairs", "chunk_slots", "qd_written_bytes",
                 "qd_read_bytes", "qd_dense_bytes", "given_list_ms",
                 "column_tests", "f64_abs_err", "twin_f64_abs_err",
                 "empty_launch_ms", "shape", "tree_widths", "probe",
                 "mirror_abs_err", "cases")
LI2_BOXES = (("ortho", (4.0, 4.2, 4.4)),
             ("triclinic", ((4.0, 0.0, 0.0), (0.6, 4.2, 0.0),
                            (0.4, -0.3, 4.4))))
GOLDEN_TOL = 0.01     # kJ/mol (benchmarks/validate_parity.py)
PARITY_TOL = 1e-5     # relative, f32 on the card vs the JAX f64 result
MD_STEPS = 400
MD_STEPS_2CLR = 200
MTS_WU4_STEPS = 400   # [8], after an equal warm-up
MTS4_STEPS = 100      # [9], 4 fs outer steps, after an equal warm-up
MTS4_TURNS = ("eager", "graph", "graph", "eager")  # [9]'s run_md turns
RESUME_STEPS = 40     # [11]: the checkpoint's step, and the steps resumed
SHAKE_LIMIT = 3.6e-6  # 30 eps of float32, the constraint tolerance floor
NEIGHBOR_EVERY = 40
V2_STEPS = 100        # [14] AGBNP2 1li2 Langevin steps, after an equal warm-up
V0_STEPS = 20         # [14] GVolSA 1li2 Langevin steps
# the in-repo AGBNP2 anchor (tests/test_agbnp2.py::V2_GOLDEN): the f64
# oracle's energy on the first 40 atoms of the fixture
V2_GOLDEN_ATOMS, V2_GOLDEN_E = 40, -505.76495633268286
V2_F64_TOL = 1e-9     # relative, the port's f64 plain route vs the anchor
# max-err / max|f| of AGBNP2's f32 forces (kernels) against its f64 plain
# route: f32 through two overlap trees, the MS free volumes' subtractions
# and the pair sweeps
V2_FORCE_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(x, ref):
    import torch

    scale = float(torch.max(torch.abs(ref)))
    diff = float(torch.max(torch.abs(x.double() - ref.double())))
    return diff / max(scale, 1e-30), diff


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps back-to-back calls (CUDA events,
    after one warm-up call).  A device-side sleep queued first holds the
    GPU while the host enqueues every call, so the host's launch overhead
    does not enter the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock cycles
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 50) -> float:
    """cuda_time_ms of one replay of fn() captured as a CUDA graph (after
    one eager call, captured on a side stream)."""
    import torch

    fn()
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        fn()
        graph.capture_end()
    main.wait_stream(side)
    return cuda_time_ms(graph.replay, reps)


def system(name):
    from openmm_agbnp_plugin_tpu_torch import AGBNPParams, load_dms

    d = load_dms(os.path.join(HERE, "benchmarks", "data",
                              f"{name}_agbnp1.dms"))
    return d, AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                          alpha=d.agbnp_alpha, charge=d.charges,
                          ishydrogen=d.ishydrogen)


def phase_build():
    from openmm_agbnp_plugin_tpu_torch.runtime import build

    t0 = time.perf_counter()
    path, compiler_log = build.build()
    build.load_library()
    dt = time.perf_counter() - t0
    for line in compiler_log.splitlines():
        if "ptxas" in line or "spill" in line or "error" in line.lower():
            log(f"  {line.strip()}")
    log(f"[1] kernels built in {dt:.2f} s -> {os.path.relpath(path, HERE)}")


def kernel_inputs(dev, name):
    """A system's layouts for the sweeps: real positions, types, tables and
    exclusion rows; screening factors from a seed; Born radii and chain
    factors from the plain twins (so every value is in its real range)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.md.forces import MMForceField
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
        arrays_from_numpy, prepare_arrays)
    from openmm_agbnp_plugin_tpu_torch.models.constants import PIFAC
    from openmm_agbnp_plugin_tpu_torch.ops.born import (
        agbnp_swf_invbr, born_chain_factors)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system(name)
    n = p.n
    npad = PK.pad_to(n, PK.pick_tile(n))
    an = prepare_arrays(p, dtype=np.float32, pair_pad=npad,
                        positions=d.positions,
                        pairs=(np.zeros(1, np.int32),) * 2)
    a = arrays_from_numpy(an, dev, torch.float32)
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(d.positions, dtype=torch.float32, device=dev)
    rperm = a["rperm"]
    pos_pad = torch.nn.functional.pad(pos[rperm], (0, 0, 0, npad - n)).T \
        .contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    pos_h = (pos[hids.clamp(min=0)] * hvalid[:, None]).T.contiguous()
    s_h = torch.where(hvalid, torch.as_tensor(
        rng.uniform(0.3, 1.0, hids.shape[0]), dtype=torch.float32,
        device=dev), 0.0)
    mm = MMForceField.from_dms(d, dtype=np.float32)
    er = mm.excl_rows()
    rinv = an["rinv"]
    epm = np.where(er >= 0, rinv[np.clip(er, 0, None)], -1)[an["rperm"]]
    excl = torch.full((npad, er.shape[1]), -1, dtype=torch.int32, device=dev)
    excl[:n] = torch.as_tensor(epm.astype(np.int32), device=dev)

    def padv(x):
        return torch.nn.functional.pad(x, (0, npad - n))

    sig = padv(torch.as_tensor(mm.arrays["sigma"], device=dev)[rperm])
    epsq = padv(torch.as_tensor(mm.arrays["epsq"], device=dev)[rperm])
    spline = PK.SplineArgs(a["hids_perm_pad"], a["type_rows_pad"],
                           a["type_cols_hpad"], a["ytab"], a["y2tab"], n, 1.0)
    born_args = (pos_pad, pos_h, *spline[:5], s_h, n)
    raw, q, dq = PK.born_sums_reference(*born_args, horizon=1.0,
                                        save_qd=True)
    filt, fp = agbnp_swf_invbr(1.0 / a["radii_vdw_perm"] - PIFAC * raw[:n])
    br = padv(1.0 / filt)
    gb_args = (pos_pad, a["charge_pad"], br, n)
    mm_kw = dict(cutoff=1.0, sig_pad=sig, epsq_pad=epsq, excl_rows_pad=excl)
    _, yrow, _, _ = PK.gb_pair_reference(*gb_args, **mm_kw)
    brw, bru = born_chain_factors(a["alpha_perm"], a["charge_pad"][:n],
                                  1.0 / filt, fp, yrow[:n])
    desc_args = (pos_pad, pos_h, s_h, padv(brw), padv(bru))
    shapes = dict(NP=npad, NHP=int(hids.shape[0]), E=int(er.shape[1]))
    return dict(born_args=born_args, gb_args=gb_args, mm_kw=mm_kw,
                desc_args=desc_args, qd=(q, dq), spline=spline,
                shapes=shapes, tile=PK.pick_tile(n),
                valid=(torch.arange(npad, device=dev) < n, hvalid))


def tile_list(inp, rng_dist, triangular=False, box=None, headroom=True):
    """A list built on the card, with the budget _sized_pair_tiles would
    give it (count x1.5, 8-aligned, at most every tile pair) or, with
    headroom where that leaves none, count + 8, so entries past nv are
    exercised."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    pos_pad, pos_h = inp["born_args"][:2]
    rvalid, hvalid = inp["valid"]
    tile = inp["tile"]
    rb = TL.tile_bounds(pos_pad, rvalid, tile)
    cb = rb if triangular else TL.tile_bounds(pos_h, hvalid, tile)
    count = int(TL.build_tile_list(*rb, *cb, rng_dist, 1,
                                   triangular=triangular, box=box)[2])
    nti, ntj = rb[1].shape[0], cb[1].shape[0]
    ntot = nti * (nti + 1) // 2 if triangular else nti * ntj
    lmax = int(min(max(8, math.ceil(count * 1.5 / 8) * 8), ntot))
    if headroom and lmax <= count:
        lmax = count + 8
    tl, nv, _ = TL.build_tile_list(*rb, *cb, rng_dist, lmax,
                                   triangular=triangular, box=box)
    if not int(nv[0]) == count <= lmax:
        raise AssertionError(f"list nv {int(nv[0])} count {count} lmax "
                             f"{lmax}")
    return tl, nv, f"nv {count}/lmax {lmax} of {ntot}"


def live_pairs(inp, kind, rng_dist):
    """Pairs this run's data makes live, counted on the card from the
    twins' own masks: GB's unordered pairs i < j < n within the cutoff
    (each list or dense sweep needs every one once), the Born sweep's
    (which both descreening variants share) within the horizon."""
    pos_pad, pos_h = inp["born_args"][:2]
    return count_live(pos_pad, pos_h, inp["born_args"][-1], inp["spline"],
                      kind, rng_dist)


def count_live(pos_pad, pos_h, n, spline, kind, rng_dist, block=2048):
    """live_pairs of the rows pos_pad [3, NP] against the columns pos_h
    [3, NHP] (GB: against the rows themselves), counted in blocks of rows
    so the masks of a large system stay small."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    ids = torch.arange(pos_pad.shape[1], device=pos_pad.device)
    total = 0
    for lo in range(0, pos_pad.shape[1], block):
        rows = ids[lo:lo + block]
        if kind == "gb":
            d2 = PK._pair_geom(pos_pad[:, rows], pos_pad, None)[3]
            mask = ((rows[:, None] < ids[None, :]) & (ids[None, :] < n)
                    & (d2 < rng_dist * rng_dist))
        else:
            d2 = PK._pair_geom(pos_pad[:, rows], pos_h, None)[3]
            mask = PK._born_qdq(torch.sqrt(d2), rows[:, None],
                                spline.hids_perm.long()[None, :], n,
                                rng_dist, spline.type_rows.long()[rows, None],
                                spline.type_cols.long()[None, :],
                                spline.yval, spline.y2val)[2]
        total += int(mask.sum())
    return total


def nbytes(*xs) -> int:
    """Bytes of the tensors among xs (in tuples, lists and dict values)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif isinstance(x, dict):
            total += nbytes(*x.values())
    return total


def bound_ms(live, ops_per_pair, moved):
    """(least ms the card could take, "operations" or "bytes"): the larger
    of live pairs x operations over the FP32 peak and the bytes moved (each
    input read once, each output written once) over HBM's rate."""
    t_ops = live * ops_per_pair / PEAK_FP32 * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@functools.lru_cache(maxsize=None)
def widest_level(dev, name):
    """The widest level of a system's overlap tree as the model's tree pass
    holds it at the model's capacities, padding rows included: dict(table
    [P, 8] f32, the first 8 packed columns of the level above; pmono32 and
    atom32 [R] int32, the ids the pass gathers parent and atom rows with;
    pmono [R] int64 and lengths [P], what its segment sum takes; nvalid, the
    valid rows, which come first; nparents P; natoms; label)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    d, p = system(name)
    m = AGBNPModel(p, device=dev, dtype=torch.float32,
                   positions=d.positions)
    pos = torch.as_tensor(d.positions, dtype=torch.float32, device=dev)
    a, pair_rows, _ = M.tree_candidates(m.arrays, pos, m.neighbor_rcut,
                                        m.neighbor_kmax, m.neighbor_grid)
    out = M.tree_passes(a, pos, m.caps, p.roffset, pair_rows=pair_rows)
    levels, diag = out[3], out[5]
    if T.check_overflow(diag)["any"]:
        raise AssertionError(f"{name}: the sized tree overflowed")
    counts = diag["counts"][0].tolist()
    w = max(range(1, len(counts)), key=counts.__getitem__)
    table = levels[w - 1]["_dat"][:, :8].contiguous()
    bnd = levels[w]["bnd"]
    return dict(
        table=table, pmono32=bnd["pmono32"], atom32=bnd["atom32"],
        pmono=bnd["pmono"], lengths=bnd["lengths"], nvalid=counts[w],
        nparents=table.shape[0], natoms=p.n, label=(
            f"{name} level {w + 2}: {bnd['pmono'].shape[0]} rows "
            f"({counts[w]} valid) from {table.shape[0]} parents"))


def tree_width_tables(dev, lvl, widths):
    """For each (columns, "parent" or "atom") of widths, a seeded f32 table
    of that width ([P] or [N] for one column, as the tree's gamma vectors
    are) and the level's ids into it."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(8)
    out = []
    for cols, which in widths:
        size = lvl["nparents"] if which == "parent" else lvl["natoms"]
        shape = (size,) if cols == 1 else (size, cols)
        out.append((cols, which, torch.rand(shape, generator=gen,
                                            dtype=torch.float32, device=dev),
                    lvl["pmono32"] if which == "parent" else lvl["atom32"]))
    return out


def probe_inputs(dev, rows, parents):
    """The row probe's inputs from numpy seeds, as the JAX package's probe
    makes them: (ids [rows] int32, table [parents, 8], payload [rows, 8])."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels.rows import make_segments

    def rand(seed, n):
        return torch.as_tensor(np.random.RandomState(seed).rand(n, 8),
                               dtype=torch.float32, device=dev)

    return (torch.as_tensor(make_segments(rows, parents), device=dev),
            rand(1, parents), rand(2, rows))


def row_timed(kern, plain, lib, moved, live=0):
    """A row kernel's, its twin's and the library call's device ms, and the
    bound of moved bytes (or live operations)."""
    b_ms, b_by = bound_ms(live, 1, moved)
    return dict(ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain),
                library_ms=cuda_time_ms(lib), bound_ms=b_ms,
                bound_by=b_by, bytes=moved)


def take_timed(tab, iv):
    """take_rows(tab, iv) timed beside its twin and torch.index_select."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    # index_select takes a matrix; a vector is its one column
    tab2 = tab if tab.dim() == 2 else tab[:, None]
    row_bytes = tab2.shape[1] * 4
    # the bytes these ids need: the ids, each table row they name once
    # (not the rows no id reaches), and the output
    named = torch.unique(iv[(iv >= 0) & (iv < tab.shape[0])]).numel()
    rec = row_timed(lambda: RW.take_rows(tab, iv),
                    lambda: RW.take_rows_reference(tab, iv),
                    lambda: torch.index_select(tab2, 0, iv),
                    nbytes(iv) + (named + iv.shape[0]) * row_bytes)
    return dict(rec, rows_named=named)


def check_row_kernels(dev, results):
    """#8 and #9 against their twins, at the probe's default shape and at
    the widest level of 2clr's tree: take_rows bitwise (also with ids out
    of range and unsorted, at every width the tree gives it, and from a
    table at an odd word address), cumsum_rows twice (bitwise), against the
    twin and against an f64 cumsum, and the gather-free broadcast's
    deviation from the gather.  Times take_rows at the widest of the tree's
    shapes (2clr's widest level, both parameterizations' packed rows) and
    at each other width, cumsum_rows at the probe's default shape, beside
    the library calls torch.index_select and torch.cumsum."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    ids, table, x = probe_inputs(dev, PROBE_ROWS, PROBE_PARENTS)
    lvl = widest_level(dev, "2clr")
    lvl_table, lvl_ids = lvl["table"], lvl["pmono32"]
    log(f"[2] row kernels vs plain twins, f32: probe shape {PROBE_ROWS} rows "
        f"x 8 from {PROBE_PARENTS} parents; {lvl['label']}")

    def take_equal(what, tab, iv):
        out = RW.take_rows(tab, iv)
        if not (torch.equal(out, RW.take_rows_reference(tab, iv))
                and torch.equal(out, RW.take_rows(tab, iv))):
            raise AssertionError(f"take_rows {what}: differs from the twin, "
                                 "or between two launches")
        return out

    def wild_ids(size, nrows):
        gen = torch.Generator(device=dev).manual_seed(3)
        return torch.randint(-5, size + 5, (nrows,), generator=gen,
                             device=dev, dtype=torch.int32)

    wide = {(w[0], w[1]): w[2] for w in tree_width_tables(
        dev, lvl, ((26, "parent"),))}[26, "parent"]
    for at, tab, idv in (("probe", table, ids), ("2clr", lvl_table, lvl_ids),
                         ("2clr, 26 columns", wide, lvl_ids)):
        nrows, npar = idv.shape[0], tab.shape[0]
        for how, iv in (("sorted ids", idv), ("unsorted, out-of-range ids",
                                              wild_ids(npar, nrows))):
            take_equal(f"{at} {how}", tab, iv)
            log(f"    take_rows                   {at} {how}: bitwise equal "
                "to the twin, twice")
        # the level's gathered payload, signed values included; at 26
        # columns the carry takes the group level (ntiles * C > 4,096)
        d = RW.take_rows(tab, idv) if at != "probe" else x
        out = RW.cumsum_rows(d)
        if not torch.equal(out, RW.cumsum_rows(d)):
            raise AssertionError(f"cumsum_rows {at}: two launches differ")
        # the kernel's summation order is the mirror's, bit for bit
        mirror = RW.cumsum_rows_mirror(d)
        if not torch.equal(out, mirror):
            raise AssertionError(f"cumsum_rows {at}: differs from "
                                 "cumsum_rows_mirror")
        # every output is a chain of at most 8 + log2(parts) + a few
        # look-back sums of rounded partial sums, each below the running
        # sum of |d|: that sum sets the scale
        scale = float(torch.cumsum(d.double().abs(), 0).max())
        ref64 = torch.cumsum(d.double(), 0)
        twin = RW.cumsum_rows_reference(d)
        e64 = float((out.double() - ref64).abs().max())
        etw = float((out - twin).abs().max())
        # the twin adds a column's R rows one after another in f32 and
        # drifts from the exact sum by up to R eps / 2 of the scale: the
        # kernel may stand as far from the twin as the twin from f64, plus
        # its own bound
        twin64 = float((twin.double() - ref64).abs().max())
        log(f"    cumsum_rows                 {at}: repeatable bitwise, "
            f"bitwise cumsum_rows_mirror; vs "
            f"f64 {e64 / scale:.3e}, vs twin {etw / scale:.3e} (twin vs f64 "
            f"{twin64 / scale:.3e}) of max cumsum|d| {scale:.4g}")
        if not (e64 <= KERNEL_TOL * scale
                and etw <= twin64 + KERNEL_TOL * scale):
            raise AssertionError(f"cumsum_rows {at}: outside {KERNEL_TOL} of "
                                 "f64, or further from the twin than the "
                                 "twin from f64")
        rec = results["cumsum_rows"]
        rec["max_abs_err"] = max(rec["max_abs_err"], etw)
        rec["f64_abs_err"] = max(rec.get("f64_abs_err", 0.0), e64)
        rec["twin_f64_abs_err"] = max(rec.get("twin_f64_abs_err", 0.0),
                                      twin64)
        rec["mirror_abs_err"] = max(rec.get("mirror_abs_err", 0.0), float(
            (out - mirror).abs().max()))
        dev_b = RW.broadcast_deviation(tab, idv)
        limit = nrows * 1.2e-7 * float(tab.abs().max())
        log(f"    gather-free broadcast       {at}: max|cumsum_rows("
            f"boundary_diffs) - take_rows| = {dev_b:.3e} (limit R eps "
            f"max|v| = {limit:.3e})")
        if not dev_b <= limit:
            raise AssertionError(f"broadcast {at}: deviation {dev_b:.3e}")

    # take_rows at the tree's own shapes: the widest level of 2clr's tree
    # at each width a pass gathers, the twin held first on the timed inputs
    # and on wild ids, then a table that starts one word off a 16-byte
    # address
    widths = []
    for cols, which, tab, iv in tree_width_tables(
            dev, lvl, TREE_WIDTHS + PADDED_WIDTHS):
        what = f"2clr {cols} columns, {which} ids"
        out = take_equal(what, tab, iv)
        take_equal(f"{what}, wild", tab, wild_ids(tab.shape[0], iv.shape[0]))
        off = torch.empty(tab.numel() + 1, dtype=torch.float32,
                          device=dev)[1:].view(tab.shape).copy_(tab)
        if not torch.equal(take_equal(f"{what}, odd address", off, iv), out):
            raise AssertionError(f"take_rows {what}: an odd word address "
                                 "changed the rows")
        rec = dict(cols=cols, ids=which, rows=iv.shape[0],
                   table_rows=tab.shape[0],
                   piece_bytes=RW.take_rows_piece_bytes(tab, out),
                   **take_timed(tab, iv))
        widths.append(rec)
        log(f"    take_rows {what:32s} {rec['rows']} rows from "
            f"{rec['rows_named']} of {rec['table_rows']}, "
            f"{rec['piece_bytes']}-byte pieces: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"torch.index_select {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['bytes']} "
            "bytes)")
    tree = [w for w in widths if (w["cols"], w["ids"]) in TREE_WIDTHS]
    main = max(tree, key=lambda w: w["bytes"])
    padded = {w["cols"]: w["ms"] for w in widths if w not in tree}
    by_cols = {w["cols"]: w["ms"] for w in tree if w["ids"] == "parent"}
    log(f"    take_rows packed rows as they are against padded to whole "
        f"16-byte pieces: 13 columns {by_cols[13]:.4f} ms, 16 columns "
        f"{padded[16]:.4f} ms; 26 columns {by_cols[26]:.4f} ms, 28 columns "
        f"{padded[28]:.4f} ms")
    probe = take_timed(table, ids)
    results["take_rows"].update(
        {k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by")},
        library="torch.index_select",
        shape=(f"{main['rows']} rows x {main['cols']} from "
               f"{main['table_rows']} ({lvl['label']})"),
        tree_widths=widths, probe=probe)
    rec = row_timed(lambda: RW.cumsum_rows(x),
                    lambda: RW.cumsum_rows_reference(x),
                    lambda: torch.cumsum(x, 0), 2 * nbytes(x), x.numel())
    rec["empty_launch_ms"] = results["gb_pair"].get("empty_launch_ms")
    results["cumsum_rows"].update(rec, library="torch.cumsum")
    log(f"    cumsum_rows at the probe shape: {rec['ms']:.4f} ms in one "
        f"launch (two-pass design before the redesign "
        f"{BEFORE_MS['cumsum_rows', 'probe']:.4f} ms), bound "
        f"{rec['bound_ms']:.4f} ms, an empty launch "
        f"{rec['empty_launch_ms']:.4f} ms")
    for name, r in (("take_rows", probe), ("cumsum_rows", rec)):
        lib = "torch.index_select" if name == "take_rows" else "torch.cumsum"
        log(f"    probe {name:21s} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, {lib} {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bytes']} bytes"
            + (f", {r['rows_named']} table rows named"
               if "rows_named" in r else "") + ")")


def phase_kernels(dev):
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL
    from openmm_agbnp_plugin_tpu_torch.runtime import build

    results = {name: dict(max_abs_err=0.0) for name in KERNELS}

    def compare(name, label, outs, refs):
        worst_abs = 0.0
        for k, (o, r) in enumerate(zip(outs, refs)):
            if r is None:
                if o is not None:
                    raise AssertionError(f"{name} {label}: output {k} extra")
                continue
            if tuple(o.shape) != tuple(r.shape):
                raise AssertionError(f"{name} {label}: output {k} shape "
                                     f"{tuple(o.shape)} != {tuple(r.shape)}")
            rel, diff = rel_err(o, r)
            log(f"    {name:27s} {label:34s} out{k}: max|d|/max|ref| = "
                f"{rel:.3e}")
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"{name} {label} output {k}: {rel:.3e} "
                                     f"> {KERNEL_TOL}")
            worst_abs = max(worst_abs, diff)
        rec = results[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)

    def compare_born(label, out, ref, nv, live):
        """#5 against its twin: raw in full, Q/dQ on the sub-tile pairs its
        keep bits name (undefined elsewhere), where the twin must hold all
        of its Q/dQ; the keep bits against subtile_live's mirror.  Returns
        the kept sub-tile pairs."""
        flags = TL.keep_flags(out[3], nv)
        if not torch.equal(flags, live):
            raise AssertionError(f"born_sums_tiles {label}: keep bits differ "
                                 f"from subtile_live in "
                                 f"{int((flags != live).sum())} places")
        kept = TL._expand_subtiles(flags)
        if bool(ref[1][~kept].any()) or bool(ref[2][~kept].any()):
            raise AssertionError(f"born_sums_tiles {label}: twin Q/dQ outside "
                                 "the kept sub-tile pairs")
        compare("born_sums_tiles", label + " (Q/dQ kept)",
                (out[0], out[1][kept], out[2][kept]),
                (ref[0], ref[1][kept], ref[2][kept]))
        return int(flags.sum())

    def compare_dense_born(label, out, ref):
        """#1 against its twin: raw in full, Q/dQ in the chunk layout on
        the slots of the chunks it walks (undefined elsewhere).  Returns
        the number of those slots (of one row each)."""
        chunks = out[3]
        slots = PK.chunk_slots(chunks)
        compare("born_sums", label, (out[0], out[1][slots], out[2][slots]),
                (ref[0], PK.chunk_layout(ref[1], chunks)[slots],
                 PK.chunk_layout(ref[2], chunks)[slots]))
        return int(slots.sum()) * 32

    def check_dense(inp, at, boxes):
        """The chunk list (bitwise its twin) and over it #1, the reload
        from #1's chunk-layout Q/dQ and #4 against their twins, at horizons
        1 and 2 nm, without a box and with each box, every kernel launched
        twice and held bitwise equal."""
        born_args, desc_args = inp["born_args"], inp["desc_args"]
        n = born_args[-1]
        for box_name, box in (("", None), *boxes):
            box = None if box is None else torch.tensor(box, device=dev)
            for hz in (1.0, None):
                label = f"{at} {box_name or 'no box'} h={hz or 2.0}"
                kw = dict(box=box, horizon=hz)
                chunks = PK.subtile_columns(*born_args[:3], n, **kw)
                twin = PK.subtile_columns_reference(*born_args[:3], n, **kw)
                if not all(torch.equal(x, y) for x, y in zip(chunks, twin)):
                    raise AssertionError(f"subtile_columns {label}: differs "
                                         "from its twin")
                repeatable("subtile_columns", label, chunks,
                           PK.subtile_columns(*born_args[:3], n, **kw))
                log(f"    {'subtile_columns':27s} {label:34s} bitwise its "
                    f"twin ({int(chunks.ncols.sum())} columns listed)")
                out = PK.born_sums(*born_args, save_qd=True, chunks=chunks,
                                   **kw)
                ref = PK.born_sums_reference(*born_args, save_qd=True, **kw)
                compare_dense_born(label, out, ref)
                slots = PK.chunk_slots(chunks)
                # again over the given list, and building its own
                for how in ("given", "built"):
                    again = PK.born_sums(*born_args, save_qd=True, **kw,
                                         chunks=chunks if how == "given"
                                         else None)
                    if how == "built" and not all(
                            torch.equal(x, y) for x, y in zip(again[3], twin)):
                        raise AssertionError(f"born_sums {label}: its own "
                                             "chunk list differs from the "
                                             "twin's")
                    repeatable("born_sums", f"{label} {how}",
                               (out[0], out[1][slots], out[2][slots]),
                               (again[0], again[1][slots], again[2][slots]))
                outs = PK.descreening(*desc_args, out[1:], box=box)
                compare("descreening", label, outs, PK.descreening_reference(
                    *desc_args, ref[1:], box=box))
                repeatable("descreening", label, outs,
                           PK.descreening(*desc_args, out[1:], box=box))
                sp = inp["spline"]._replace(horizon=hz)
                dd = (*desc_args, None)
                outs = PK.descreening(*dd, box=box, spline=sp, chunks=chunks)
                compare("descreening_recompute", label, outs,
                        PK.descreening_reference(*dd, box=box, spline=sp))
                repeatable("descreening_recompute", label, outs,
                           PK.descreening(*dd, box=box, spline=sp,
                                          chunks=chunks))

    def timed_dense(inp):
        """The dense chunk sweeps to time at horizon 1 nm without a box:
        the chunk list, #1 building its own (also walking a given one), the
        reload from #1's Q/dQ and #4.  The bounds count what the TPU
        function reads and writes, not the list."""
        born_args, desc_args = inp["born_args"], inp["desc_args"]
        n = born_args[-1]
        chunks = PK.subtile_columns(*born_args[:3], n, horizon=1.0)
        qd_k = PK.born_sums(*born_args, horizon=1.0, save_qd=True)[1:]
        slots = int(PK.chunk_slots(chunks).sum()) * 32
        live_b = live_pairs(inp, "born", 1.0)
        sp = inp["spline"]._replace(horizon=1.0)
        dd = (*desc_args, None)
        return {
            "subtile_columns": dict(
                kern=lambda: PK.subtile_columns(*born_args[:3], n,
                                                horizon=1.0),
                plain=lambda: PK.subtile_columns_reference(
                    *born_args[:3], n, horizon=1.0),
                reads=born_args[:3], live=chunks.cols.numel(),
                live_key="column_tests", ops="chunk_test", extra=0),
            "born_sums": dict(
                kern=lambda: PK.born_sums(*born_args, horizon=1.0,
                                          save_qd=True),
                plain=lambda: PK.born_sums_reference(*born_args, horizon=1.0,
                                                     save_qd=True),
                reads=born_args, live=live_b, ops="born",
                extra=8 * live_b, born_chunks=True,
                also=dict(given_list_ms=lambda: PK.born_sums(
                    *born_args, horizon=1.0, save_qd=True, chunks=chunks))),
            "descreening": dict(
                kern=lambda: PK.descreening(*desc_args, qd_k),
                plain=lambda: PK.descreening_reference(*desc_args, inp["qd"]),
                reads=desc_args, live=live_b, ops="descreen",
                extra=8 * live_b,
                info=dict(chunk_slots=slots,
                          qd_read_bytes=slots * QD_SLOT_BYTES)),
            "descreening_recompute": dict(
                kern=lambda: PK.descreening(*dd, spline=sp, chunks=chunks),
                plain=lambda: PK.descreening_reference(*dd, spline=sp),
                reads=(dd, sp), live=live_b, ops="descreen_spline",
                extra=0, info=dict(chunk_slots=slots)),
        }

    def born_live(inp, nv, tl, rng_dist, box=None):
        pos_pad, pos_h = inp["born_args"][:2]
        return TL.subtile_live(nv, tl, pos_pad, inp["valid"][0], pos_h,
                               inp["valid"][1], inp["tile"], rng_dist,
                               box=box)

    def check_lists(inp, at, boxes=()):
        """#5-#7 against their twins on inp's lists: Born and descreening
        (the reload from the Born kernel's Q/dQ and keep bits and from the
        twin's Q/dQ, and the recompute) at horizons 1 and 2 nm, GB with and
        without MM at cutoff 1 nm, each kernel twice (bitwise), and with
        each box at horizon and cutoff 1 nm.  Returns the calls to time: at
        1 nm, without a box, on lists with the budgets the model gives
        them."""
        tile = inp["tile"]
        born_args, gb_args, mm_kw = inp["born_args"], inp["gb_args"], \
            inp["mm_kw"]
        for box_name, box in (("", None), *boxes):
            box = None if box is None else torch.tensor(box, device=dev)
            where = f"{at}{' ' + box_name if box_name else ''}"
            for hz in ((1.0, None) if box is None else (1.0,)):
                tl, nv, what = tile_list(inp, hz or 2.0, box=box)
                label = f"{where} h={hz or 2.0} {what}"
                args = (nv, tl, *born_args, tile)
                kw = dict(box=box, horizon=hz, save_qd=True)
                out = TL.born_sums_tiles(*args, **kw)
                ref = TL.born_sums_tiles_reference(*args, **kw)
                live = born_live(inp, nv, tl, hz or 2.0, box)
                compare_born(label, out, ref, nv, live)
                again = TL.born_sums_tiles(*args, **kw)
                kept = TL._expand_subtiles(live)
                nvv = int(nv[0])
                repeatable("born_sums_tiles", label,
                           (out[0], out[1][kept], out[2][kept], out[3][:nvv]),
                           (again[0], again[1][kept], again[2][kept],
                            again[3][:nvv]))
                sp = inp["spline"]._replace(horizon=hz)
                dargs = (nv, tl, *inp["desc_args"])
                for name, qd, spl, how in (
                        ("descreening_tiles", out[1:], sp, "keep bits"),
                        ("descreening_tiles", ref[1:], sp, "twin Q/dQ"),
                        ("descreening_tiles", ref[1:], None,
                         "twin Q/dQ, no spline"),
                        ("descreening_tiles_recompute", None, sp, "")):
                    kw = dict(box=box, spline=spl)
                    outs = TL.descreening_tiles(*dargs, qd, tile, **kw)
                    compare(name, f"{label} {how}", outs,
                            TL.descreening_tiles_reference(
                                *dargs, None if qd is None else ref[1:],
                                tile, **kw))
                    repeatable(name, label, outs,
                               TL.descreening_tiles(*dargs, qd, tile, **kw))
            tl_g, nv_g, what = tile_list(inp, 1.0, triangular=True, box=box)
            gargs = (nv_g, tl_g, *gb_args, tile)
            for mm, kw in (("MM", mm_kw), ("no MM", dict(cutoff=1.0))):
                kw = dict(kw, box=box)
                label = f"{where} c=1 {mm} {what}"
                outs = TL.gb_pair_tiles(*gargs, **kw)
                compare("gb_pair_tiles", label, outs,
                        TL.gb_pair_tiles_reference(*gargs, **kw))
                repeatable("gb_pair_tiles", label, outs,
                           TL.gb_pair_tiles(*gargs, **kw))
        tl, nv, what_b = tile_list(inp, 1.0, headroom=False)
        tl_g, nv_g, what_g = tile_list(inp, 1.0, triangular=True,
                                       headroom=False)
        log(f"    {at} lists timed: Born {what_b}, GB {what_g}")
        args = (nv, tl, *born_args, tile)
        qd_k = TL.born_sums_tiles(*args, horizon=1.0, save_qd=True)[1:]
        qd = TL.born_sums_tiles_reference(*args, horizon=1.0,
                                          save_qd=True)[1:]
        dargs = (nv, tl, *inp["desc_args"])
        gargs = (nv_g, tl_g, *gb_args, tile)
        sp = inp["spline"]._replace(horizon=1.0)
        live_b = live_pairs(inp, "born", 1.0)
        kept = int(born_live(inp, nv, tl, 1.0).sum())
        return {
            "born_sums_tiles": dict(
                kern=lambda: TL.born_sums_tiles(*args, horizon=1.0,
                                                save_qd=True),
                plain=lambda: TL.born_sums_tiles_reference(
                    *args, horizon=1.0, save_qd=True),
                reads=args, live=live_b, ops="born", extra=8 * live_b,
                born_list=(nv, born_live(inp, nv, tl, 1.0))),
            "gb_pair_tiles": dict(
                kern=lambda: TL.gb_pair_tiles(*gargs, **mm_kw),
                plain=lambda: TL.gb_pair_tiles_reference(*gargs, **mm_kw),
                reads=(gargs, mm_kw), live=live_pairs(inp, "gb", 1.0),
                ops="gb_mm", extra=0),
            "descreening_tiles": dict(
                kern=lambda: TL.descreening_tiles(*dargs, qd_k, tile,
                                                  spline=sp),
                plain=lambda: TL.descreening_tiles_reference(
                    *dargs, qd, tile, spline=sp),
                reads=(dargs, qd_k[2]), live=live_b, ops="descreen",
                extra=8 * live_b,
                info=dict(kept_subtile_pairs=kept,
                          qd_read_bytes=kept * QD_SUBTILE_BYTES)),
            "descreening_tiles_recompute": dict(
                kern=lambda: TL.descreening_tiles(*dargs, None, tile,
                                                  spline=sp),
                plain=lambda: TL.descreening_tiles_reference(
                    *dargs, None, tile, spline=sp),
                reads=(dargs, sp), live=live_b, ops="descreen_spline",
                extra=0, info=dict(kept_subtile_pairs=kept)),
        }

    def check_dense_gb(inp, at, boxes=()):
        """#2, the GB list kernel over every tile pair ti <= tj of the dense
        grid, against its twin: cutoff 1 nm and none, with and without the
        fused MM terms, with each box at 1 nm, every call twice (bitwise)."""
        gb_args, mm_kw = inp["gb_args"], inp["mm_kw"]
        no_cut = dict(mm_kw, cutoff=None)
        cases = [("cutoff=1, MM", mm_kw), ("cutoff=1, no MM",
                                           dict(cutoff=1.0)),
                 ("no cutoff, MM", no_cut), ("no cutoff, no MM", {})]
        cases += [(f"cutoff=1, MM, {name}",
                   dict(mm_kw, box=torch.tensor(box, device=dev)))
                  for name, box in boxes]
        for label, kw in cases:
            outs = PK.gb_pair(*gb_args, **kw)
            compare("gb_pair", f"{at} {label}", outs,
                    PK.gb_pair_reference(*gb_args, **kw))
            repeatable("gb_pair", f"{at} {label}", outs,
                       PK.gb_pair(*gb_args, **kw))

    def repeatable(name, label, outs, again):
        if not all(x is None if y is None else torch.equal(x, y)
                   for x, y in zip(outs, again)):
            raise AssertionError(f"{name} {label}: two launches differ")

    def measure(timed, at):
        """Check each kernel against its twin on the inputs it is timed on,
        time both, and bound the kernel by this run's data.
        extra: bytes moved beyond the tensors read and returned, such as
        Q/dQ at 8 bytes a live pair.  The Born sweeps' Q/dQ outputs count
        only that way; the bytes of their [lmax or NP, T or NHP] arrays
        are reported beside as qd_dense_bytes, and for the list sweep the
        bytes it writes (its kept 32x32 sub-tile pairs) as
        qd_written_bytes."""
        out = {}
        for name, t in timed.items():
            written = t["kern"]()
            rec = dict(t.get("info", {}))
            if "born_list" in t:
                nv, live = t["born_list"]
                kept = compare_born(f"{at} as timed", written, t["plain"](),
                                    nv, live)
                rec.update(kept_subtile_pairs=kept,
                           qd_written_bytes=kept * QD_SUBTILE_BYTES,
                           qd_dense_bytes=nbytes(written[1:3]))
                written = (written[0], written[3])
            elif "born_chunks" in t:
                slots = compare_dense_born(f"{at} as timed", written,
                                           t["plain"]())
                rec.update(chunk_slots=slots,
                           qd_written_bytes=slots * QD_SLOT_BYTES,
                           qd_dense_bytes=nbytes(written[1:3]))
                written = written[0]
            else:
                compare(name, f"{at} as timed", written, t["plain"]())
            moved = nbytes(t["reads"], written) + t["extra"]
            b_ms, b_by = bound_ms(t["live"], OPS_PER_PAIR[t["ops"]], moved)
            rec.update(ms=cuda_time_ms(t["kern"]),
                       plain_ms=cuda_time_ms(t["plain"]), bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
            rec[t.get("live_key", "live_pairs")] = t["live"]
            for key, fn in t.get("also", {}).items():
                rec[key] = cuda_time_ms(fn)
            out[name] = rec
            before = (f", before the redesign {BEFORE_MS[name, at]:.4f} ms "
                      "(PERF.md)" if (name, at) in BEFORE_MS else "")
            sizes = "".join(f"; {x} {rec[x]}" for x in RECORD_EXTRAS
                            if x in rec)
            log(f"    {at:4s} {name:27s} kernel {rec['ms']:.4f} ms{before}, "
                f"plain {rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; {t['live']} "
                f"{t.get('live_key', 'live_pairs').replace('_', ' ')}, "
                f"{moved} bytes{sizes})")
        return out

    # dense grid, 1li2 shapes
    li2 = kernel_inputs(dev, "1li2")
    log(f"[2] kernels vs plain twins, f32: dense grid at 1li2 "
        f"{li2['shapes']}")
    if li2["shapes"] != dict(NP=1536, NHP=768, E=24):
        raise AssertionError(f"unexpected 1li2 shapes {li2['shapes']}")
    l_gb, l_mm = li2["gb_args"], li2["mm_kw"]
    check_dense_gb(li2, "1li2", LI2_BOXES)
    check_dense(li2, "1li2", LI2_BOXES)
    timed_1li2 = dict(timed_dense(li2), gb_pair=dict(
        kern=lambda: PK.gb_pair(*l_gb, **l_mm),
        plain=lambda: PK.gb_pair_reference(*l_gb, **l_mm),
        reads=(l_gb, l_mm), live=live_pairs(li2, "gb", 1.0), ops="gb_mm",
        extra=0))
    # #4's main record is at 2clr's shapes; 1li2's rides beside it
    timed_1li2["descreening_recompute"]["sub"] = "dense_1li2"
    log(f"[2] kernels vs plain twins, f32: lists at 1li2 {li2['shapes']} "
        f"(T {li2['tile']}; mts_wu4's route), boxes too")
    timed_1li2_lists = check_lists(li2, "1li2", LI2_BOXES)

    # interacting-tile lists and the recomputing dense sweep, 2clr shapes
    clr = kernel_inputs(dev, "2clr")
    log(f"[2] kernels vs plain twins, f32: lists and dense descreening at "
        f"2clr {clr['shapes']} (T {clr['tile']})")
    if clr["shapes"] != dict(NP=6144, NHP=3328, E=24):
        raise AssertionError(f"unexpected 2clr shapes {clr['shapes']}")
    check_dense(clr, "2clr", LI2_BOXES)
    check_dense_gb(clr, "2clr")
    timed_2clr = check_lists(clr, "2clr")
    timed_2clr["descreening_recompute"] = timed_dense(clr)[
        "descreening_recompute"]
    log("    times: device ms per call, CUDA events behind a device sleep, "
        "horizon and cutoff 1 nm; bound from the H100 SXM peaks (67 TFLOP/s "
        f"FP32, 3.35 TB/s); library_ms null, {LIBRARY_NONE}")
    for at, timed, sub in (("1li2", timed_1li2, None),
                           ("1li2", timed_1li2_lists, "lists_1li2"),
                           ("2clr", timed_2clr, None)):
        for name, rec in measure(timed, at).items():
            key = sub or timed[name].get("sub")
            if key:
                results[name][key] = rec
            else:
                results[name].update(rec)
    # what is left under #2's bound of a few tenths of a microsecond: the
    # sweep and its reduce are two launches, and even a kernel that does
    # nothing takes this long from launch to finish
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty_launch():
        if lib.agbnp_empty_launch(stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    results["gb_pair"].update(empty_launch_ms=cuda_time_ms(empty_launch))
    log(f"    an empty kernel, launch to finish: "
        f"{results['gb_pair']['empty_launch_ms']:.4f} ms a launch; gb_pair "
        f"is 2 launches (sweep, reduce), bound "
        f"{results['gb_pair']['bound_ms']:.4f} ms")
    check_row_kernels(dev, results)
    check_replica_axis(dev, "1li2", lists=True, dense=True)
    check_replica_axis(dev, "2clr", lists=True, dense=False)
    return results


REPLICA_BATCH = 3     # [2]: replicas of the batched launches
REPLICA_JITTER = 0.01  # nm, the replicas' displacement (numpy seed)


def replica_batch(inp, nb, seed=1):
    """A batch of nb replicas of kernel_inputs' layouts: replica 0 as
    given, the others with their atoms displaced (numpy seed, REPLICA_JITTER
    nm) and their screening factors, Born radii and chain factors scaled,
    the heavy columns taken from the displaced rows (so each replica is one
    consistent system).  Returns per-replica (pos_pad, pos_h, s_h, born,
    brw, bru), each [nb, ...]."""
    import numpy as np
    import torch

    pos_pad, pos_h = inp["born_args"][:2]
    s_h = inp["born_args"][7]
    born = inp["gb_args"][2]
    brw, bru = inp["desc_args"][3:5]
    rvalid, hvalid = inp["valid"]
    hperm = inp["spline"].hids_perm.long().clamp(min=0)
    rng = np.random.default_rng(seed)
    dev = pos_pad.device

    def rnd(shape, scale):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device=dev)

    out = ([], [], [], [], [], [])
    for b in range(nb):
        if b == 0:
            pp = pos_pad
        else:
            pp = pos_pad + rnd(pos_pad.shape, REPLICA_JITTER) * rvalid
        ph = torch.where(hvalid, pp[:, hperm], 0.0)
        f = 1.0 + 0.05 * b
        for lst, x in zip(out, (pp, ph, s_h / f, born * f, brw * f,
                                bru / f)):
            lst.append(x.contiguous())
    return tuple(torch.stack(x).contiguous() for x in out)


def check_replica_axis(dev, name, lists=True, dense=True):
    """The replica axis of the pair kernels at a system's shapes: a batch of
    REPLICA_BATCH replicas in one launch (counted once in LAUNCHES) against
    each replica's own B = 1 launch, bitwise, for every output the kernel
    defines (Q/dQ on the chunk slots or kept sub-tile pairs only); the
    batched lists against each replica's own list, bitwise."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    inp = kernel_inputs(dev, name)
    nb = REPLICA_BATCH
    pos_b, posh_b, s_b, born_b, brw_b, bru_b = replica_batch(inp, nb)
    sp = inp["spline"]
    n = inp["born_args"][-1]
    tables = inp["born_args"][2:7]
    charge = inp["gb_args"][1]
    mm_kw = inp["mm_kw"]
    rvalid, hvalid = inp["valid"]
    tile = inp["tile"]
    boxes = (None,) + tuple(b for _, b in LI2_BOXES) if name == "1li2" \
        else (None,)

    def same(label, out, refs, mask=None):
        """out [nb, ...] (nested) bitwise refs[b] for every replica."""
        if isinstance(out, torch.Tensor):
            for b, r in enumerate(refs):
                o = out[b]
                if mask is not None:
                    o, r = o[mask[b]], r[mask[b]]
                if not torch.equal(o, r):
                    raise AssertionError(f"[2] replica axis {name} {label}: "
                                         f"replica {b} differs from its "
                                         f"B = 1 launch")
            return
        for k, o in enumerate(out):
            if o is None:
                continue
            same(f"{label}.{k}", o, [r[k] for r in refs],
                 None if mask is None else mask[k])

    def once(kname, fn):
        before = PK.LAUNCHES[kname]
        out = fn()
        if PK.LAUNCHES[kname] - before != 1:
            raise AssertionError(f"[2] {kname}: {PK.LAUNCHES[kname] - before}"
                                 f" launches for one batched call")
        return out

    checked = []
    for box in boxes:
        bl = "none" if box is None else ("ortho" if len(box) == 3 and
                                          not hasattr(box[0], "__len__")
                                          else "triclinic")
        box_t = None if box is None else torch.as_tensor(
            box, dtype=torch.float32, device=dev)
        for horizon in ((1.0, 2.0) if dense else ()):
            spb = sp._replace(horizon=horizon)
            ch = once("subtile_columns", lambda: PK.subtile_columns(
                pos_b, posh_b, sp.hids_perm, n, box=box_t, horizon=horizon))
            ch1 = [PK.subtile_columns(pos_b[b], posh_b[b], sp.hids_perm, n,
                                      box=box_t, horizon=horizon)
                   for b in range(nb)]
            same(f"subtile_columns h{horizon} {bl}", ch, ch1)
            out = once("born_sums", lambda: PK.born_sums(
                pos_b, posh_b, *tables, s_b, n, box=box_t, horizon=horizon,
                save_qd=True))
            ref = [PK.born_sums(pos_b[b], posh_b[b], *tables, s_b[b], n,
                                box=box_t, horizon=horizon, save_qd=True)
                   for b in range(nb)]
            slots = torch.stack([PK.chunk_slots(r[3]) for r in ref])
            same(f"born_sums h{horizon} {bl}", (out[0], out[3]),
                 [(r[0], r[3]) for r in ref])
            same(f"born_sums Q/dQ h{horizon} {bl}", out[1:3],
                 [r[1:3] for r in ref], mask=(slots, slots))
            raw = once("born_sums", lambda: PK.born_sums(
                pos_b, posh_b, *tables, s_b, n, box=box_t, horizon=horizon,
                chunks=ch))
            same(f"born_sums given list h{horizon} {bl}", raw,
                 [r[0] for r in ref])
            d = once("descreening", lambda: PK.descreening(
                pos_b, posh_b, s_b, brw_b, bru_b, out[1:], box=box_t))
            same(f"descreening h{horizon} {bl}", d,
                 [PK.descreening(pos_b[b], posh_b[b], s_b[b], brw_b[b],
                                 bru_b[b], ref[b][1:], box=box_t)
                  for b in range(nb)])
            d = once("descreening_recompute", lambda: PK.descreening(
                pos_b, posh_b, s_b, brw_b, bru_b, None, box=box_t,
                spline=spb, chunks=ch))
            same(f"descreening_recompute h{horizon} {bl}", d,
                 [PK.descreening(pos_b[b], posh_b[b], s_b[b], brw_b[b],
                                 bru_b[b], None, box=box_t, spline=spb,
                                 chunks=ch1[b]) for b in range(nb)])
            checked.append(f"dense h{horizon} {bl}")
        if dense:
            for kw in (mm_kw, dict(cutoff=None)):
                g = once("gb_pair", lambda: PK.gb_pair(
                    pos_b, charge, born_b, n, box=box_t, **kw))
                same(f"gb_pair {bl} mm={'sig_pad' in kw}", g,
                     [PK.gb_pair(pos_b[b], charge, born_b[b], n, box=box_t,
                                 **kw) for b in range(nb)])
        if not lists:
            continue
        rb = TL.tile_bounds(pos_b, rvalid, tile)
        cb = TL.tile_bounds(posh_b, hvalid, tile)
        for rng_d in (1.0, 2.0):
            spb = sp._replace(horizon=rng_d)
            cnt = TL.build_tile_list(*rb, *cb, rng_d, 1, box=box_t)[2]
            lmax = int(math.ceil(int(cnt.max()) * 1.5 / 8) * 8)
            tl, nv, _ = TL.build_tile_list(*rb, *cb, rng_d, lmax, box=box_t)
            one = [TL.build_tile_list(
                *TL.tile_bounds(pos_b[b], rvalid, tile),
                *TL.tile_bounds(posh_b[b], hvalid, tile), rng_d, lmax,
                box=box_t) for b in range(nb)]
            same(f"build_tile_list {rng_d} {bl}", (tl, nv),
                 [o[:2] for o in one])
            out = once("born_sums_tiles", lambda: TL.born_sums_tiles(
                nv, tl, pos_b, posh_b, *tables, s_b, n, tile, box=box_t,
                horizon=rng_d, save_qd=True))
            ref = [TL.born_sums_tiles(nv[b], tl[b], pos_b[b], posh_b[b],
                                      *tables, s_b[b], n, tile, box=box_t,
                                      horizon=rng_d, save_qd=True)
                   for b in range(nb)]
            # keep bits are written for the entries below nv only
            ent = (torch.arange(lmax, device=dev)[None, :] < nv).expand(
                nb, lmax)
            same(f"born_sums_tiles {rng_d} {bl}", out[0], [r[0] for r in ref])
            same(f"born_sums_tiles keep {rng_d} {bl}", out[3],
                 [r[3] for r in ref], mask=ent)
            kept = torch.stack([TL._expand_subtiles(TL.keep_flags(r[3],
                                                                  nv[b]))
                                for b, r in enumerate(ref)])
            same(f"born_sums_tiles Q/dQ {rng_d} {bl}", out[1:3],
                 [r[1:3] for r in ref], mask=(kept, kept))
            d = once("descreening_tiles", lambda: TL.descreening_tiles(
                nv, tl, pos_b, posh_b, s_b, brw_b, bru_b, out[1:], tile,
                box=box_t, spline=spb))
            same(f"descreening_tiles {rng_d} {bl}", d,
                 [TL.descreening_tiles(nv[b], tl[b], pos_b[b], posh_b[b],
                                       s_b[b], brw_b[b], bru_b[b], ref[b][1:],
                                       tile, box=box_t, spline=spb)
                  for b in range(nb)])
            d = once("descreening_tiles_recompute",
                     lambda: TL.descreening_tiles(
                         nv, tl, pos_b, posh_b, s_b, brw_b, bru_b, None, tile,
                         box=box_t, spline=spb))
            same(f"descreening_tiles_recompute {rng_d} {bl}", d,
                 [TL.descreening_tiles(nv[b], tl[b], pos_b[b], posh_b[b],
                                       s_b[b], brw_b[b], bru_b[b], None, tile,
                                       box=box_t, spline=spb)
                  for b in range(nb)])
        cnt = TL.build_tile_list(*rb, *rb, 1.0, 1, triangular=True,
                                 box=box_t)[2]
        lmax = int(math.ceil(int(cnt.max()) * 1.5 / 8) * 8)
        tl, nv, _ = TL.build_tile_list(*rb, *rb, 1.0, lmax, triangular=True,
                                       box=box_t)
        for kw in (mm_kw, dict(cutoff=1.0)):
            g = once("gb_pair_tiles", lambda: TL.gb_pair_tiles(
                nv, tl, pos_b, charge, born_b, n, tile, box=box_t, **kw))
            same(f"gb_pair_tiles {bl} mm={'sig_pad' in kw}", g,
                 [TL.gb_pair_tiles(nv[b], tl[b], pos_b[b], charge, born_b[b],
                                   n, tile, box=box_t, **kw)
                  for b in range(nb)])
        checked.append(f"lists {bl} (nv {[int(x) for x in nv[:, 0]]})")
    log(f"[2] replica axis at {name}: B = {nb} in one launch bitwise each "
        f"replica's B = 1 launch, every kernel ({'; '.join(checked)})")


def phase_goldens(dev):
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
        load_gaussvol_dat

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    for version, anchor in ((0, 872.514), (1, -2476.66)):
        m = AGBNPModel(p, device=dev, dtype=torch.float32, version=version,
                       positions=pos)
        e, f, out = m.energy_forces(pos, with_details=True)
        if m.check_and_grow(out["diag"]):
            raise AssertionError("fixture tree overflowed its capacities")
        e = float(e)
        log(f"[3] golden v{version}: E = {e:.4f} (anchor {anchor})")
        if not abs(e - anchor) < GOLDEN_TOL:
            raise AssertionError(f"golden v{version}: {e} vs {anchor}")
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"golden v{version}: non-finite forces")


def sized_model(dev, p, positions, **kw):
    """AGBNPModel on the card in f32 whose capacities (tree, neighbor
    width, tile budgets) were grown until one evaluation at `positions`
    is clean.  Returns (model, energy, force)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel

    m = AGBNPModel(p, device=dev, dtype=torch.float32, version=1,
                   positions=positions, **kw)
    for _ in range(8):
        e, f, out = m.energy_forces(positions, with_details=True)
        if not m.check_and_grow(out["diag"]):
            return m, e, f
    raise AssertionError("capacities did not converge")


def check_parity(name, e, f, phase="[4]"):
    import numpy as np

    ref = np.load(os.path.join(HERE, "benchmarks", ".parity_cache",
                               f"{name}_agbnp1_f64.npz"))
    e_ref, f_ref = float(ref["e"]), ref["f"]
    fn = f.double().cpu().numpy()
    if fn.shape != f_ref.shape or not np.isfinite(fn).all():
        raise AssertionError(f"{name} forces: shape {fn.shape}, finite "
                             f"{np.isfinite(fn).all()}")
    e_rel = abs(float(e) - e_ref) / abs(e_ref)
    f_rel = float(np.abs(fn - f_ref).max() / np.abs(f_ref).max())
    log(f"{phase} {name} vs JAX f64: E = {float(e):.4f} (ref {e_ref:.4f}), "
        f"energy rel {e_rel:.3e}, force max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError(f"{name} parity outside {PARITY_TOL}")


def check_repeatable(name, m, positions, e, f):
    import torch

    e2, f2 = m.energy_forces(positions)
    same = bool(torch.equal(e, e2)) and bool(torch.equal(f, f2))
    log(f"[5] {name} bitwise repeatable: {same}")
    if not same:
        raise AssertionError(f"{name}: two evaluations differ")


def phase_parity(dev):
    """Phases 4-5.  Returns the launch counts of the sharing-off
    evaluations (the path of the two recomputing descreening kernels and
    of the standalone chunk list)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    for name in ("trpcage", "1li2", "rnaseh", "1dwc"):
        d, p = system(name)
        m, e, f = sized_model(dev, p, d.positions)
        check_parity(name, e, f)
        log(f"[4] {name}: {p.n} atoms, pair_tiles {m.pair_tiles}, "
            f"neighbor_kmax {m.neighbor_kmax}, cell grid "
            f"{m.neighbor_grid is not None}, caps {m.caps.caps}")
        if name == "rnaseh" and not (m.neighbor_kmax > 0
                                     and m.neighbor_grid is None):
            raise AssertionError("rnaseh must build its tree candidates with "
                                 "half_neighbor_pairs on the device, without "
                                 "a cell grid")
        if name == "1li2":
            check_repeatable("1li2", m, d.positions, e, f)

    d, p = system("2clr")
    t0 = time.perf_counter()
    m, e, f = sized_model(dev, p, d.positions)
    log(f"[4] 2clr model sized in {time.perf_counter() - t0:.1f} s: "
        f"pair_tiles {m.pair_tiles}, neighbor_kmax {m.neighbor_kmax}, "
        f"cell grid {m.neighbor_grid.dims.tolist()} x ccap "
        f"{m.neighbor_grid.ccap}, caps {m.caps}")
    if m.pair_tiles is None or m.pair_tiles[1] is not None:
        raise AssertionError("2clr without a cutoff must run Born and "
                             "descreening on lists and GB dense")
    check_parity("2clr", e, f)
    check_repeatable("2clr", m, d.positions, e, f)
    ref_dense = AGBNPModel(p, device=dev, dtype=torch.float32, caps=m.caps,
                           positions=d.positions, pair_tiles=False)
    recompute = dict.fromkeys(("subtile_columns", "descreening_recompute",
                               "descreening_tiles_recompute"), 0)
    for route, m_on in (("lists", m), ("dense", ref_dense)):
        m_off = AGBNPModel(p, device=dev, dtype=torch.float32, caps=m.caps,
                           positions=d.positions,
                           pair_tiles=m_on.pair_tiles or False,
                           share_qd=False)
        e_on, f_on = m_on.energy_forces(d.positions)
        PK.reset_launch_counts()
        e_off, f_off = m_off.energy_forces(d.positions)
        counts = PK.launch_counts()
        for k in recompute:
            recompute[k] += counts[k]
        e_rel = abs(float(e_off) - float(e_on)) / abs(float(e_on))
        f_rel, _ = rel_err(f_off, f_on)
        log(f"[4] 2clr {route}: sharing off vs on: energy rel {e_rel:.3e}, "
            f"force max-err/max|f| {f_rel:.3e}; launches "
            f"{ {k: c for k, c in counts.items() if c} }")
        if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
            raise AssertionError(f"2clr {route}: sharing off differs")
        if counts["take_rows"] < 1:
            raise AssertionError(f"[4] 2clr {route}: the tree's passes did "
                                 "not launch take_rows")
    return recompute


def md_sim(dev, name, **kw):
    """The port's Simulation of a system in bench.py's setting: f32,
    CutoffNonPeriodic 1 nm, descreening horizon at the cutoff, skin
    0.25 nm."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation

    d, _ = system(name)
    return Simulation(d, device=dev, version=1, cutoff=1.0,
                      dtype=torch.float32, skin=0.25,
                      descreen_horizon="cutoff", **kw)


def v2_sim(dev, name, grow: bool = True):
    """The port's Simulation of a system in AGBNP2 in the 1li2-md-v2
    cell's setting: f32, CutoffNonPeriodic 1 nm, skin 0.25 nm; with grow,
    its capacities grown by one run_md window first (JAX's MS-tree
    neighbor width, 64, is short for 1li2), as the cell's warm-up grows
    them."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation

    d, _ = system(name)
    sim = Simulation(d, device=dev, version=2, cutoff=1.0,
                     dtype=torch.float32, skin=0.25)
    if grow:
        sim.run_md(NEIGHBOR_EVERY, neighbor_every=NEIGHBOR_EVERY)
    return sim


def run_md(dev, card, name, steps, label, sim=None, bench=None, **kw):
    """benchmark_langevin (warm-up + timed run of `steps`) on a fresh
    Simulation (or `sim`), with the launch counts of the whole call.
    bench: benchmark_langevin options beyond bench.py's strict run."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    sim = md_sim(dev, name, **kw) if sim is None else sim
    bench = {**dict(dt=0.001, neighbor_every=NEIGHBOR_EVERY), **(bench or {})}
    PK.reset_launch_counts()
    r = sim.benchmark_langevin(nsteps=steps, temperature=300.0,
                               friction=1.0, max_regrow=3, **bench)
    counts = PK.launch_counts()
    energies = r["energies"]
    ms_step = r["elapsed_s"] / r["steps_run"] * 1e3
    wu = ("vdW-compact WU pass" if bench.get("vdw_compact", True)
          else "full WU pass")
    log(f"{label} {name} MD {bench}, {wu}: {steps} steps x2 (warm-up + "
        f"timed), regrows {r['regrows']}, overflow {r['overflow']}, "
        f"pair_tiles "
        f"{sim.agbnp.pair_tiles}, cell grid {sim.grid is not None}, "
        f"E first/last {energies[0]:.2f}/{energies[-1]:.2f}")
    lean = sim.agbnp.caps
    padded = T.TreeCaps.for_natoms(sim.agbnp.params.n)
    log(f"    tree rows per level {lean.caps} = {sum(lean.caps)}, windows "
        f"{lean.offs} (TreeCaps.for_natoms: {padded.caps} = "
        f"{sum(padded.caps)}, windows {padded.offs})")
    log(f"    kernel launches { {k: c for k, c in counts.items() if c} }")
    log(f"    first measurement, not a claim: {ms_step:.3f} ms/step, "
        f"{r['ns_day']:.3f} ns/day on {card}")
    # the warm-up and the timed run: every (outer) step runs the cavity
    # pass, and the WU pass every wu_every-th
    passes = 2 * steps * (1 + 1 / bench.get("wu_every", 1))
    check_tree_launches(counts, passes, label)
    if r["overflow"]:
        raise AssertionError(f"capacity overflow after {r['regrows']} "
                             "regrows")
    if energies.shape != (steps,) or not np.isfinite(energies).all():
        raise AssertionError("non-finite or missing MD energies")
    if not bool(torch.isfinite(r["final_pos"]).all()):
        raise AssertionError("non-finite final positions")
    return sim, counts, r


def check_tree_launches(counts, passes, label):
    """At least `passes` fixed-topology tree passes in counts: each a
    tree_rescan and a tree_reduce launch at every level of the tree and a
    tree_deposit launch (window builds and regrown attempts add more)."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    want = dict(tree_rescan=T.NUM_TREE_LEVELS * passes,
                tree_reduce=T.NUM_TREE_LEVELS * passes, tree_deposit=passes)
    short = {k: (counts[k], v) for k, v in want.items() if counts[k] < v}
    if short:
        raise AssertionError(f"{label} tree kernel launches (counted, at "
                             f"least) {short}")


def phase_md(dev, card):
    """Phases 6-7: 1li2 on the dense grid, 2clr on the lists (both with
    the vdW-compact WU pass, the runners' default as in JAX)."""
    import torch

    _, counts_1li2, _ = run_md(dev, card, "1li2", MD_STEPS, "[6]",
                               pair_tiles=False)
    for name in ("born_sums", "gb_pair", "descreening"):
        if counts_1li2[name] < MD_STEPS:
            raise AssertionError(f"{name}: {counts_1li2[name]} launches < "
                                 f"{MD_STEPS} steps")

    sim, counts_2clr, _ = run_md(dev, card, "2clr", MD_STEPS_2CLR, "[7]")
    if sim.grid is None or sim.agbnp.pair_tiles is None \
            or sim.agbnp.pair_tiles[1] is None:
        raise AssertionError("2clr MD must run on both lists and the grid")
    for name in ("born_sums_tiles", "gb_pair_tiles", "descreening_tiles"):
        if counts_2clr[name] < MD_STEPS_2CLR:
            raise AssertionError(f"{name}: {counts_2clr[name]} launches < "
                                 f"{MD_STEPS_2CLR} steps")
    torch.cuda.synchronize()
    return counts_1li2, counts_2clr


def check_list_launches(counts, steps, label, qd_shared=True):
    """Every list kernel launched at least once per (outer) step: the
    descreening sweep reloading the Born sweep's Q/dQ, or recomputing the
    spline where the list's Q/dQ are not shared (lb T^2 8 over
    QD_BYTES_LIMIT)."""
    seven = "descreening_tiles" + ("" if qd_shared else "_recompute")
    for name in ("born_sums_tiles", "gb_pair_tiles", seven):
        if counts[name] < steps:
            raise AssertionError(f"{label} {name}: {counts[name]} launches "
                                 f"< {steps} steps")


def window_start(sim, pos):
    """What the MD runner builds at a rebuild: neighbor list, tree
    topology, vdW rescan and the compacted WU topology at pos."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    a = sim.agbnp.arrays
    pairs = sim.neighbor_fn(pos, sim.heavy_mask, sim.rcut_list, sim.kmax)[:3]
    gdr = a["gamma"] / sim.agbnp.params.roffset
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"], gdr,
                         a["ishydrogen"])
    levels, _ = T.build_tree(lvl1, pairs[0], pairs[1], sim.agbnp.caps,
                             pairs_valid=pairs[2], pair_rows=True)
    topo = T.tree_topology(levels)
    lvl1v = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"], -gdr,
                          a["ishydrogen"])
    lv = T.rescan_volumes(topo, lvl1v)
    caps = sim._ensure_vdw_caps()
    vt, counts = T.compact_topology(lv, caps)
    return dict(pairs=pairs, topology=topo, levels_vdw=lv, vdw_caps=caps,
                vdw_topology=vt, vdw_counts=counts)


def phase_mts_wu4(dev, card):
    """Phase 8: bench.py's headline configuration (mts_wu4) on 1li2 on the
    tile lists.  Returns the sized Simulation and the run's launch
    counts."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.md.integrators import (
        langevin_middle_step, wu_impulse_langevin_steps)

    sim = md_sim(dev, "1li2")
    pos0, vel0 = sim.positions, sim.velocities
    w = window_start(sim, pos0)
    mk = dict(pairs=w["pairs"], topology=w["topology"], ff=sim.ff_state())
    vt = w["vdw_topology"]
    fwu_c = sim.force_fn(wu_mode="split", vdw_topology=vt, **mk)(pos0)[2]
    fwu_f = sim.force_fn(wu_mode="split", **mk)(pos0)[2]
    rel, _ = rel_err(fwu_c, fwu_f)
    kept = int(w["vdw_counts"].sum())
    rows = sum(int(t["valid"].sum()) for t in w["topology"])
    log(f"[8] compacted WU pass at a window start: {kept} of {rows} tree "
        f"rows kept (caps {w['vdw_caps']}); force_wu vs the full pass "
        f"max|d|/max|ref| = {rel:.3e}")
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"compacted WU force differs: {rel:.3e}")

    # one window of WU impulse steps with k=1 against the plain fused
    # step, on the same noise
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = [torch.randn(pos0.shape, generator=gen, dtype=pos0.dtype,
                         device=dev) for _ in range(NEIGHBOR_EVERY)]
    args = (sim.masses, 0.001, 300.0, 1.0)
    plain = langevin_middle_step(sim.force_fn(vdw_topology=vt, **mk), *args)
    [impulse] = wu_impulse_langevin_steps(
        sim.force_fn(wu_mode="split", vdw_topology=vt, **mk),
        sim.force_fn(wu_mode="skip", vdw_topology=vt, **mk), *args, 1)(1)
    p0, v0, p1, v1 = pos0, vel0, pos0, vel0
    for xi in noise:
        p0, v0, *_ = plain(p0, v0, xi)
        p1, v1, *_ = impulse(p1, v1, xi)
    rel_p, _ = rel_err(p1, p0)
    rel_v, _ = rel_err(v1, v0)
    bitwise = bool(torch.equal(p0, p1)) and bool(torch.equal(v0, v1))
    log(f"[8] {NEIGHBOR_EVERY} WU impulse steps (k=1) vs the plain "
        f"fused step: pos {rel_p:.3e}, vel {rel_v:.3e}, bitwise {bitwise}")
    if not (rel_p <= KERNEL_TOL and rel_v <= KERNEL_TOL):
        raise AssertionError("the k=1 WU impulse step left the plain step")

    sim, counts, _ = run_md(dev, card, "1li2", MTS_WU4_STEPS, "[8]",
                            sim=sim, bench=dict(wu_every=4))
    if sim.agbnp.pair_tiles is None or sim._vdw_caps is None:
        raise AssertionError("mts_wu4 must run on the lists, vdW-compact")
    check_list_launches(counts, MTS_WU4_STEPS, "[8]")
    return sim, counts


def phase_mts4_constraints(dev, card):
    """Phase 9: bench.py's mts4fs_constraints configuration on 1li2: the
    benchmark_langevin run (the SHAKE limit), a replayed outer step's
    device ms and its parts' (graph_ms), then MTS4_TURNS run_md
    calls of MTS4_STEPS outer steps from the same start and noise, each a
    fresh runner (its first window's first step eager, its second
    captured, every later step a replay), eager and graphed in turns as
    [34]'s: wall and CUDA-event ms an outer step, md.graph_step_pct (the
    replayed steps over the md.step spans), every turn bitwise the first
    with the same launch tallies."""
    import statistics

    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    sim = md_sim(dev, "1li2", constraints=True)
    mts = dict(dt=0.004, mts_inner=2, neighbor_every=10)
    sim, counts, r = run_md(dev, card, "1li2", MTS4_STEPS, "[9]", sim=sim,
                            bench=mts)
    cons = sim.constraints
    viol = float(cons.max_violation(r["final_pos"].double()))
    log(f"[9] (times per 4 fs outer step) SHAKE: {cons.n_constraints} "
        f"constraints, {cons.sweeps} Newton sweeps, largest window residual "
        f"{r['shake_residual']:.3e} (tolerance "
        f"{cons.tolerance(r['final_pos'].dtype):.3e}); final max violation "
        f"{viol:.3e} (limit {SHAKE_LIMIT})")
    if not viol <= SHAKE_LIMIT:
        raise AssertionError(f"constraint violation {viol:.3e}")
    check_list_launches(counts, MTS4_STEPS, "[9]")

    # a replayed outer step's device time by part, each part captured and
    # replayed alone at a window's start
    from openmm_agbnp_plugin_tpu_torch.md.integrators import \
        mts_langevin_step

    pos, vel = sim.positions, sim.velocities
    ff = sim.ff_state()
    pairs, topo, vt, _ = sim.window_build(pos[None], ff,
                                          sim._ensure_vdw_caps())
    slow, fast = sim.force_fn(pairs=pairs, topology=topo, ff=ff, split=True,
                              vdw_topology=vt)
    step = mts_langevin_step(slow, fast, sim.masses, mts["dt"], 300.0, 1.0,
                             mts["mts_inner"], constraints=cons)
    noise = torch.randn((mts["mts_inner"],) + tuple(pos.shape),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        dtype=pos.dtype, device=dev)
    drifted = pos + 0.002 * vel
    part = {k: graph_ms(fn) for k, fn in (
        ("step", lambda: step(pos, vel, noise)),
        ("slow", lambda: slow(pos)),
        ("fast", lambda: fast(pos)),
        ("shake", lambda: cons.shake(drifted, pos)),
        ("rattle", lambda: cons.velocities(pos, vel)))}
    calls = dict(slow=1, fast=mts["mts_inner"], shake=mts["mts_inner"],
                 rattle=mts["mts_inner"] + 1)
    share = {k: 100.0 * n * part[k] / part["step"] for k, n in calls.items()}
    log(f"[9] a replayed outer step's device ms {part['step']:.4f}; by part "
        f"(ms a call x calls a step, % of the step): "
        + ", ".join(f"{k} {part[k]:.4f} x {n} = {share[k]:.1f}%"
                    for k, n in calls.items())
        + f"; constraints (SHAKE + RATTLE) "
        f"{share['shake'] + share['rattle']:.1f}%; {card}")

    every = mts["neighbor_every"]
    ms = dict(eager=[], graph=[])
    pct = {}
    first = None
    for turn in MTS4_TURNS:
        ctx = eager_windows() if turn == "eager" else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        PK.reset_launch_counts()
        profiling.reset()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with ctx, profiling.record():
            t0 = time.perf_counter()
            ev[0].record()
            out = sim.run_md(MTS4_STEPS, report_interval=every,
                             generator=torch.Generator(device=dev)
                             .manual_seed(2), **mts)
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / MTS4_STEPS
        rec = profiling.recorded()
        profiling.reset()
        launches = PK.launch_counts()
        steps = sum(sp["name"] == "md.step" for sp in rec["spans"])
        replays = sum(c["n"] for c in rec["counts"]
                      if c["name"] == "md.graph_replay")
        pct[turn] = 100.0 * replays / steps
        want = 0 if turn == "eager" else MTS4_STEPS - 1
        if out["regrows"] or replays != want:
            raise AssertionError(f"[9] {turn}: regrows {out['regrows']}, "
                                 f"{replays} replayed steps, expected {want}")
        viol = float(cons.max_violation(out["final_pos"].double()))
        if not viol <= SHAKE_LIMIT:
            raise AssertionError(f"[9] {turn}: constraint violation "
                                 f"{viol:.3e}")
        ms[turn].append((wall, ev[0].elapsed_time(ev[1]) / MTS4_STEPS))
        res = (out["final_pos"], out["final_vel"],
               torch.as_tensor(out["energies"]),
               torch.as_tensor(out["frames"]))
        if first is None:
            first = (res, launches)
        else:
            same_bits(first[0], res, f"[9] {turn}")
            if launches != first[1]:
                raise AssertionError(f"[9] {turn}: launches {launches} != "
                                     f"{first[1]}")
    med = {t: statistics.median(w for w, _ in v) for t, v in ms.items()}
    turns = {t: [(round(w, 4), round(c, 4)) for w, c in v]
             for t, v in ms.items()}
    log(f"[9] 1li2 4 fs MTS + SHAKE/RATTLE, run_md of {MTS4_STEPS} outer "
        f"steps a turn (windows of {every}): ms an outer "
        f"step (wall, CUDA events) by turn {turns}; median eager "
        f"{med['eager']:.4f} / graph {med['graph']:.4f} wall, "
        f"x{med['eager'] / med['graph']:.3f}; md.graph_step_pct "
        f"{pct['graph']:.2f} graphed, {pct['eager']:.2f} eager; every turn "
        f"bitwise the first, launches equal; {card}")
    return counts


def phase_no_sync(dev, sim):
    """Phase 10: SHAKE, RATTLE and the WU compaction at the 1li2 shapes
    make no host sync (after one warm-up call outside the check)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    cons = Constraints.from_dms(sim.dms, device=dev)
    pos = sim.positions
    gen = torch.Generator(device=dev).manual_seed(2)
    noisy = pos + 0.002 * torch.randn(pos.shape, generator=gen,
                                      dtype=pos.dtype, device=dev)
    vel = torch.randn(pos.shape, generator=gen, dtype=pos.dtype, device=dev)
    w = window_start(sim, pos)

    def calls():
        x = cons.positions(noisy, pos)
        return x, cons.velocities(x, vel), T.compact_topology(
            w["levels_vdw"], w["vdw_caps"])[1]

    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, _, counts = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[10] Constraints.positions, Constraints.velocities and "
        f"compact_topology ran under set_sync_debug_mode('error'): no host "
        f"sync (max violation {float(cons.max_violation(x)):.2e}, kept rows "
        f"{counts.tolist()})")


def phase_resume(dev, sim):
    """Phase 11: run_md resumed from its step-40 checkpoint reproduces the
    uninterrupted 80-step trajectory bitwise on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.io.checkpoint import \
        load_checkpoint, restore_generator

    kw = dict(neighbor_every=NEIGHBOR_EVERY, report_interval=RESUME_STEPS,
              seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "md.ckpt.npz")
        first = os.path.join(tmp, "md.step40.npz")

        def keep_first(step, pos, vel):
            if step == RESUME_STEPS:
                shutil.copyfile(path, first)

        full = sim.run_md(2 * RESUME_STEPS, checkpoint_path=path,
                          reporter=keep_first, **kw)
        ck = load_checkpoint(first)
        rest = sim.run_md(RESUME_STEPS, pos=ck["positions"],
                          vel=ck["velocities"],
                          generator=restore_generator(ck, dev), **kw)
    same = (bool(torch.equal(rest["final_pos"], full["final_pos"]))
            and bool(torch.equal(rest["final_vel"], full["final_vel"]))
            and np.array_equal(rest["energies"],
                               full["energies"][RESUME_STEPS:]))
    log(f"[11] run_md {2 * RESUME_STEPS} steps vs resumed from the step-"
        f"{ck['step']} checkpoint ({ck['generator_device']} generator): "
        f"bitwise {same}; regrows {full['regrows']}/{rest['regrows']}")
    if ck["step"] != RESUME_STEPS or not same:
        raise AssertionError("the resumed trajectory differs")


def phase_row_probes(dev, card):
    """The row probe's own path: profile_port_step.py --row-probes at its
    default shape and at 2clr's widest level, with the launch counts of
    the run."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from profile_port_step import row_probes

    PK.reset_launch_counts()
    row_probes(dev, card, PROBE_ROWS, PROBE_PARENTS, PROBE_REPS)
    return PK.launch_counts()


def phase_context(dev):
    """Phase 12: the AGBNPForce/Context entry point on the card, f32."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import (
        AGBNPForce, AGBNPModel, AGBNPParams, Context, NonbondedMethod,
        load_gaussvol_dat)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    def force_of(p, version=1, n=None):
        force = AGBNPForce()
        force.setVersion(version)
        for i in range(p.n if n is None else n):
            force.addParticle(p.radius[i], p.gamma[i], p.alpha[i],
                              p.charge[i], bool(p.ishydrogen[i]))
        return force

    def evaluate(force, pos, **kw):
        ctx = Context(force, **kw)
        ctx.setPositions(pos)
        e, f = ctx.getEnergyForces()
        if not (isinstance(e, float) and f.device == dev
                and f.dtype == torch.float32
                and bool(torch.isfinite(f).all())):
            raise AssertionError("Context: energy must be a float and the "
                                 "forces finite f32 on the card")
        return ctx, e, f

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    for version, anchor in ((0, 872.514), (1, -2476.66)):
        ctx, e, _ = evaluate(force_of(p, version), pos)
        e_only = ctx.getEnergy()
        log(f"[12] Context v{version} on {ctx._device}: E = {e:.4f} (anchor "
            f"{anchor}), getEnergy {e_only:.4f}")
        if not abs(e - anchor) < GOLDEN_TOL:
            raise AssertionError(f"Context golden v{version}: {e}")
        if e_only != e:
            raise AssertionError("getEnergy differs from getEnergyForces")
    zero_e, zero_f = ctx.calcForcesAndEnergy(groups=0)
    if zero_e != 0.0 or bool(zero_f.any()) or zero_f.device != dev \
            or zero_f.dtype != torch.float32:
        raise AssertionError("calcForcesAndEnergy outside the group mask")

    # a parameter edit reaches the live Context without a new model
    force = force_of(p)
    ctx, e0, _ = evaluate(force, pos)
    model = ctx._model
    for i in range(p.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g, a, 0.5 * q, h)
    force.updateParametersInContext(ctx)
    e1, f1 = ctx.getEnergyForces()
    _, e_fresh, f_fresh = evaluate(force, pos)
    same = e1 == e_fresh and bool(torch.equal(f1, f_fresh))
    log(f"[12] updateParametersInContext (charges halved): E {e0:.4f} -> "
        f"{e1:.4f}, model kept {ctx._model is model}, equal to a fresh "
        f"Context bitwise {same}")
    if ctx._model is not model or not same or abs(e1 - e0) < 1.0:
        raise AssertionError("updateParametersInContext")

    # CutoffPeriodic in a 20 nm box against CutoffNonPeriodic
    force = force_of(p)
    force.setNonbondedMethod(NonbondedMethod.CutoffNonPeriodic)
    force.setCutoffDistance(1.2)
    _, e_np, f_np = evaluate(force, pos)
    force.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    _, e_p, f_p = evaluate(force, pos,
                           box=((20.0, 0, 0), (0, 20.0, 0), (0, 0, 20.0)))
    e_rel = abs(e_p - e_np) / abs(e_np)
    f_rel, _ = rel_err(f_p, f_np)
    log(f"[12] CutoffPeriodic (20 nm box) vs CutoffNonPeriodic: energy rel "
        f"{e_rel:.3e}, force max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError("CutoffPeriodic in a large box differs")

    # 1li2 at full width: NoCutoff, the dense kernels #1-#3
    d, p = system("1li2")
    PK.reset_launch_counts()
    ctx, e, f = evaluate(force_of(p), d.positions)
    counts = PK.launch_counts()
    m = AGBNPModel(p, device=dev, dtype=torch.float32, caps=ctx._model.caps)
    e_m, f_m = m.energy_forces(d.positions)
    e_rel = abs(e - float(e_m)) / abs(float(e_m))
    f_rel, _ = rel_err(f, f_m)
    log(f"[12] 1li2 through Context.getEnergyForces: E = {e:.4f}, vs "
        f"AGBNPModel energy rel {e_rel:.3e}, force {f_rel:.3e}; launches "
        f"{ {k: c for k, c in counts.items() if c} }")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError("1li2 Context differs from the model")
    for name in ("born_sums", "gb_pair", "descreening", "take_rows"):
        if counts[name] < 1:
            raise AssertionError(f"[12] {name} not launched by the Context")
    check_parity("1li2", e, f, phase="[12]")


def phase_v2(dev, card):
    """Phase 14: AGBNP2 through its model, Simulation and Context, and
    version 0 MD, on the card.  Returns the launch counts of the v2 MD run
    (its warm-up and timed run)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (
        AGBNPForce, AGBNPParams, Context, Simulation, load_gaussvol_dat)
    from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import \
        AGBNP2Model
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    dense = ("born_sums", "gb_pair", "descreening")
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    n = V2_GOLDEN_ATOMS
    p40 = AGBNPParams(radius=radius[:n], gamma=gamma[:n], alpha=alpha[:n],
                      charge=charge[:n], ishydrogen=ish[:n])
    for dtype in (torch.float64, torch.float32):
        m = AGBNP2Model(p40, device=dev, dtype=dtype, positions=pos[:n])
        PK.reset_launch_counts()
        e, f = m.energy_forces(pos[:n])
        counts = PK.launch_counts()
        e = float(e)
        log(f"[14] V2 anchor, {dtype}, pair kernels {m.pair_kernel}: E = "
            f"{e:.6f} (anchor {V2_GOLDEN_E}); launches "
            f"{ {k: c for k, c in counts.items() if c} }")
        if not (abs(e - V2_GOLDEN_E) < GOLDEN_TOL
                and bool(torch.isfinite(f).all())):
            raise AssertionError(f"V2 anchor {dtype}: {e}")
        kernels = dtype == torch.float32
        if m.pair_kernel != kernels or any(
                counts[k] != (1 if kernels else 0) for k in dense):
            raise AssertionError(f"V2 {dtype}: the pair phases took the "
                                 "wrong route")
        if not kernels and abs(e - V2_GOLDEN_E) > V2_F64_TOL * abs(
                V2_GOLDEN_E):
            raise AssertionError(f"V2 f64: {e} outside {V2_F64_TOL}")

    # the f64 reference's capacities grow until nothing overflows (JAX's
    # MS-tree neighbor width of 64 is short for 1li2), the f32 model
    # takes them all
    d, p = system("1li2")
    t0 = time.perf_counter()
    ref = AGBNP2Model(p, device=dev, dtype=torch.float64,
                      positions=d.positions)
    sized_kmax = ref.ms_kmax
    e0, f0, out0 = ref.energy_forces(d.positions, with_details=True)
    while ref.check_and_grow(out0["diags"]):
        e0, f0, out0 = ref.energy_forces(d.positions, with_details=True)
    m = AGBNP2Model(p, device=dev, dtype=torch.float32,
                    positions=d.positions, caps=ref.caps,
                    caps_ms=ref.caps_ms, cap_ms=ref.cap_ms,
                    ms_kmax=ref.ms_kmax, ms_sub_k=ref.ms_sub_k)
    PK.reset_launch_counts()
    e1, f1, out1 = m.energy_forces(d.positions, with_details=True)
    counts = PK.launch_counts()
    e_rel = abs(float(e1) - float(e0)) / abs(float(e0))
    f_rel, _ = rel_err(f1, f0)
    log(f"[14] 1li2 v2: E f32 kernels {float(e1):.4f}, f64 plain "
        f"{float(e0):.4f}: energy rel {e_rel:.3e}, force max-err/max|f| "
        f"{f_rel:.3e}; {int(out1['details']['num_ms'])} MS particles of "
        f"cap_ms {m.cap_ms}, caps {m.caps.caps}, MS caps {m.caps_ms.caps}, "
        f"MS-tree neighbor width {sized_kmax} -> {m.ms_kmax}; launches "
        f"{ {k: c for k, c in counts.items() if c} }; both models and "
        f"evaluations {time.perf_counter() - t0:.1f} s")
    if not (e_rel <= PARITY_TOL and f_rel <= V2_FORCE_TOL):
        raise AssertionError("1li2 v2: f32 kernels differ from f64")
    if any(counts[k] != 1 for k in dense):
        raise AssertionError("1li2 v2: #1-#3 not launched once each")
    if m.check_and_grow(out1["diags"]):
        raise AssertionError("1li2 v2: the f32 evaluation overflowed")
    del ref, out0

    sim = Simulation(d, device=dev, version=2, cutoff=1.0,
                     dtype=torch.float32, skin=0.25)
    if not sim.agbnp2.pair_kernel:
        raise AssertionError("Simulation(version=2) at f32 on the card must "
                             "run the pair kernels")
    def capacities():
        m2 = sim.agbnp2
        return dict(caps=m2.caps.caps, caps_ms=m2.caps_ms.caps,
                    cap_ms=m2.cap_ms, ms_kmax=m2.ms_kmax,
                    ms_candidate_kmax=sim.ms_kmax_list, ms_sub_k=m2.ms_sub_k)

    # JAX's MS-tree neighbor width (64) is short for 1li2 (77 at the DMS
    # positions): one window of run_md lets the PanicButton grow it before
    # the counted runs
    sized = capacities()
    pre = sim.run_md(NEIGHBOR_EVERY, dt=0.001, neighbor_every=NEIGHBOR_EVERY)
    grown = {k: (v, capacities()[k]) for k, v in sized.items()
             if capacities()[k] != v}
    log(f"[14] 1li2 v2: one {NEIGHBOR_EVERY}-step window first: regrows "
        f"{pre['regrows']}, grown (sized -> grown) {grown}")
    # a window build's peak with the MS tree's half list built in row
    # blocks (PR 9's dense [cap_ms, cap_ms] list peaked at 21.8 GB)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    sim._v2_build(sim.positions)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[14] 1li2 v2: a window build peaks at {peak / 1e9:.3f} GB "
        f"allocated ({(peak - base) / 1e9:.3f} GB above the "
        f"{base / 1e9:.3f} GB held before it; PR 9's dense MS half list: "
        f"21.8 GB) on {card}, cap_ms {sim.agbnp2.cap_ms}")
    sized = capacities()
    PK.reset_launch_counts()
    r = sim.benchmark_langevin(nsteps=V2_STEPS, temperature=300.0,
                               friction=1.0, dt=0.001,
                               neighbor_every=NEIGHBOR_EVERY, max_regrow=3)
    counts_v2 = PK.launch_counts()
    grown = {k: (v, capacities()[k]) for k, v in sized.items()
             if capacities()[k] != v}
    if grown:
        log(f"    the PanicButton grew again (sized -> grown): {grown}")
    ms_step = r["elapsed_s"] / r["steps_run"] * 1e3
    energies = r["energies"]
    log(f"[14] 1li2 v2 MD (f32, 1 nm GB cutoff, build every "
        f"{NEIGHBOR_EVERY} steps): {V2_STEPS} steps x2 (warm-up + timed), "
        f"regrows {r['regrows']}, overflow {r['overflow']}, E first/last "
        f"{energies[0]:.2f}/{energies[-1]:.2f}, cap_ms {sim.agbnp2.cap_ms}; "
        f"launches { {k: c for k, c in counts_v2.items() if c} }")
    log(f"    first measurement, not a claim: {ms_step:.3f} ms/step, "
        f"{r['ns_day']:.3f} ns/day on {card}")
    if r["overflow"] or energies.shape != (V2_STEPS,) \
            or not np.isfinite(energies).all():
        raise AssertionError("1li2 v2 MD: overflow or non-finite energies")
    if any(counts_v2[k] < 2 * V2_STEPS for k in dense) \
            or counts_v2["descreening_recompute"]:
        raise AssertionError("1li2 v2 MD: #1-#3 not launched every step, "
                             "or the recompute ran")
    # AGBNP2's window topologies carry no per-level kernels' prep: its
    # tree passes are the torch ones, their rows moved by take_rows
    if any(counts_v2[k] for k in TREE_KERNELS) or not counts_v2["take_rows"]:
        raise AssertionError("1li2 v2 MD: a tree kernel launched, or "
                             "take_rows did not")

    sim0 = Simulation(d, device=dev, version=0, cutoff=1.0,
                      dtype=torch.float32, skin=0.25)
    r0 = sim0.benchmark_langevin(nsteps=V0_STEPS, warmup=False, dt=0.001,
                                 neighbor_every=10, max_regrow=3)
    log(f"[14] 1li2 v0 MD (f32): {V0_STEPS} steps, regrows "
        f"{r0['regrows']}, overflow {r0['overflow']}, E first/last "
        f"{r0['energies'][0]:.2f}/{r0['energies'][-1]:.2f}, "
        f"{r0['elapsed_s'] / r0['steps_run'] * 1e3:.3f} ms/step")
    if r0["overflow"] or not np.isfinite(r0["energies"]).all():
        raise AssertionError("1li2 v0 MD: overflow or non-finite energies")

    def v2_force(params):
        force = AGBNPForce()
        force.setVersion(2)
        for i in range(params.n):
            force.addParticle(params.radius[i], params.gamma[i],
                              params.alpha[i], params.charge[i],
                              bool(params.ishydrogen[i]))
        return force

    ctx = Context(v2_force(p40))
    ctx.setPositions(pos[:n])
    e, f = ctx.getEnergyForces()
    e_only = ctx.getEnergy()
    log(f"[14] Context v2 on {ctx._device}: E = {e:.4f} (anchor "
        f"{V2_GOLDEN_E:.4f}), getEnergy {e_only:.4f}")
    if not (isinstance(e, float) and f.device == dev
            and f.dtype == torch.float32 and bool(torch.isfinite(f).all())
            and abs(e - V2_GOLDEN_E) < GOLDEN_TOL and e_only == e):
        raise AssertionError("Context v2 on the card")
    # 1li2: the Context's PanicButton grows the MS-tree neighbor width
    ctx = Context(v2_force(p))
    ctx.setPositions(d.positions)
    PK.reset_launch_counts()
    e, f = ctx.getEnergyForces()
    counts = PK.launch_counts()
    e_rel = abs(e - float(e1)) / abs(float(e1))
    log(f"[14] Context v2, 1li2: E = {e:.4f}, vs the f32 model at the "
        f"grown capacities rel {e_rel:.3e}; MS-tree neighbor width "
        f"{ctx._model.ms_kmax}; launches "
        f"{ {k: c for k, c in counts.items() if c} }")
    if not (e_rel <= PARITY_TOL and ctx._model.ms_kmax > sized_kmax
            and bool(torch.isfinite(f).all())
            and all(counts[k] >= 2 for k in dense)):
        raise AssertionError("Context v2 on 1li2: no regrow, or off the "
                             "f32 model")
    torch.cuda.synchronize()
    return counts_v2


# [15]-[18]: replicas as a batch on one card
ENS_REPLICAS = 8      # [15] 1li2 replicas
ENS_WARMUP = 40       # [15]-[16] warm-up steps before each timed run
ENS_STEPS = 200       # [15] timed steps
ENS_2CLR_REPLICAS = 4  # [16] BASELINE config 5
ENS_2CLR_STEPS = 80   # [16] timed steps
ENS_JITTER = 0.01     # nm, [15]'s conformers and [18]'s poses (numpy seed)
BATCH_E_TOL = 1e-6    # relative, a batched evaluation vs B = 1 on the card
BATCH_F_TOL = 1e-5    # of max|f|
REMD_REPLICAS, REMD_T = 8, (300.0, 450.0)
REMD_SPC, REMD_WARM, REMD_CYCLES = 40, 2, 5
REMD_ENS_STEPS = 120  # [17]'s ensemble turns before and after the T-REMD
SCORE_POSES = 16      # [18]
SCORE_TOL = 1e-5      # relative, the scorer vs the Context (BASELINE's bar)
REFINE_POSES, REFINE_ITERS = 4, 50
PAIR_KERNELS = ("subtile_columns", "born_sums", "gb_pair", "descreening",
                "descreening_recompute", "born_sums_tiles", "gb_pair_tiles",
                "descreening_tiles", "descreening_tiles_recompute")


def device_kernels(fn):
    """(fn's result, CUDA kernels it launched, their device ms) from a
    torch.profiler trace of one call.  The trace records the device alone:
    the CPU ops' events add nothing to the kernels and their device time
    and made processing the trace the larger part of [15] and [17]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (out, sum(e.count for e in ks),
            sum(e.self_device_time_total for e in ks) / 1e3)


def pair_launches(counts):
    return {k: counts[k] for k in PAIR_KERNELS if counts[k]}


def check_once(counts, kernels, label):
    """Each of kernels launched exactly once (one batched call)."""
    for k in kernels:
        if counts.get(k, 0) != 1:
            raise AssertionError(f"{label} {k}: {counts.get(k, 0)} launches "
                                 "for one batched call")


def check_every_step(per_step, kernels, label):
    """Each of kernels launched at least once a step."""
    for k in kernels:
        if per_step.get(k, 0.0) < 1.0:
            raise AssertionError(f"{label} {k}: not launched every step")


def jittered(positions, nb, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.asarray(positions)[None] + ENS_JITTER * rng.standard_normal(
        (nb,) + np.asarray(positions).shape)


def check_batch_vs_each(label, m, batch, out):
    """A batched evaluation's replicas against the model's own B = 1
    evaluation of each conformer."""
    worst_e = worst_f = 0.0
    for b in range(batch.shape[0]):
        e, f = m.energy_forces(batch[b])
        worst_e = max(worst_e, abs(float(out["energy"][b]) - float(e))
                      / abs(float(e)))
        worst_f = max(worst_f, rel_err(out["force"][b], f)[0])
    log(f"{label} batched vs each conformer's B = 1 evaluation: energy rel "
        f"{worst_e:.3e}, force max-err/max|f| {worst_f:.3e}")
    if not (worst_e <= BATCH_E_TOL and worst_f <= BATCH_F_TOL):
        raise AssertionError(f"{label}: batched evaluation differs")


def ensemble_run(dev, card, label, sim, nrep, steps, warmup):
    """nrep replicas through ReplicaEnsemble.make_runner: warmup steps, then
    steps timed (continuing them; host clock around a synchronised run):
    ms/step, ns/day, the pair kernels' launches a step, no overflow, finite
    energies that differ across replicas."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica

    ens = ReplicaEnsemble(sim, nrep)
    run = ens.make_runner(neighbor_every=NEIGHBOR_EVERY)
    states = ens.initial_states(jitter=1e-3)
    PK.reset_launch_counts()
    if warmup:
        states, _ = run(states, warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, (energies, *diag) = run(states, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = PK.launch_counts()
    per_step = {k: v / (steps + warmup) for k, v in
                pair_launches(counts).items()}
    e = energies.cpu().numpy()
    ms = elapsed * 1e3 / steps
    ns_day = steps * 1e-6 / elapsed * 86400.0  # 1 fs steps
    report = sim.overflow_report(*worst_replica(diag))
    log(f"{label} R = {nrep}: {ms:.3f} ms/step, {ns_day:.3f} ns/day a "
        f"replica, {ns_day * nrep:.3f} ns/day aggregate on {card}; "
        f"overflow {bool(report)}; pair kernel launches a step "
        f"{ {k: round(v, 3) for k, v in per_step.items()} }")
    if report or e.shape != (nrep, steps):
        raise AssertionError(f"{label} R = {nrep}: overflow {report}, "
                             f"energies {e.shape}")
    if not np.isfinite(e).all():
        raise AssertionError(f"{label}: non-finite energies")
    if nrep > 1 and len(np.unique(e[:, -1])) < nrep:
        raise AssertionError(f"{label}: replicas' energies do not differ")
    if not bool(torch.isfinite(states[0]).all()):
        raise AssertionError(f"{label}: non-finite positions")
    check_every_step(per_step, ("born_sums_tiles", "gb_pair_tiles",
                                "descreening_tiles"), label)
    return ms, counts


def window_kernels(sim, nrep):
    """Device kernels a step and device ms a step of one profiled rebuild
    window of nrep replicas."""
    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble

    ens = ReplicaEnsemble(sim, nrep)
    run = ens.make_runner(neighbor_every=NEIGHBOR_EVERY)
    states = ens.initial_states(jitter=1e-3, seed=5)
    run(states, NEIGHBOR_EVERY)
    _, n, ms = device_kernels(lambda: run(states, NEIGHBOR_EVERY))
    return n / NEIGHBOR_EVERY, ms / NEIGHBOR_EVERY


def phase_ensemble(dev, card):
    """Phase 15: ReplicaEnsemble of 8 x 1li2 on the tile lists (strict 1
    fs Langevin at 300 K, 1/ps, rebuilds every 40 steps, vdW-compact WU
    pass).  First a batched evaluation of 8 jittered conformers against
    each conformer's B = 1 evaluation; then R = 1 and R = 8 in turns
    through the same runner."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, batched_diag_max
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system("1li2")
    m = AGBNPModel(p, device=dev, dtype=torch.float32, cutoff=1.0,
                   descreen_horizon="cutoff", positions=d.positions)
    batch = jittered(d.positions, ENS_REPLICAS, 15)
    for _ in range(8):
        PK.reset_launch_counts()
        out = m.batched_energy_forces(batch)
        counts = PK.launch_counts()
        if not m.check_and_grow(batched_diag_max(out["diag"])):
            break
    log(f"[15] 1li2 batched evaluation of {ENS_REPLICAS} conformers "
        f"({ENS_JITTER} nm, numpy seed): pair_tiles {m.pair_tiles}, "
        f"launches {pair_launches(counts)}")
    check_once(counts, ("born_sums_tiles", "gb_pair_tiles",
                        "descreening_tiles"), "[15]")
    check_batch_vs_each("[15]", m, batch, out)
    sim = md_sim(dev, "1li2")
    runs, path_counts = {}, None
    for turn in range(2):
        for nrep in (1, ENS_REPLICAS):
            ms, counts = ensemble_run(
                dev, card, f"[15] turn {turn + 1}", sim, nrep, ENS_STEPS,
                ENS_WARMUP if turn == 0 else 0)
            runs.setdefault(nrep, []).append(ms)
            if turn == 0 and nrep == ENS_REPLICAS:
                path_counts = counts
    for nrep in (1, ENS_REPLICAS):
        k, ms = window = window_kernels(sim, nrep)
        ms_step = min(runs[nrep])
        log(f"[15] R = {nrep}: {k:.0f} kernels a step, device "
            f"{ms:.3f} ms a step in a profiled window (the device idle "
            f"{100 - ms / ms_step * 100:.1f}% of the best timed "
            f"{ms_step:.3f} ms step)")
    torch.cuda.synchronize()
    return sim, path_counts, window


def phase_ensemble_2clr(dev, card):
    """Phase 16: ReplicaEnsemble of 4 x 2clr (BASELINE config 5): the
    cell-grid candidates per replica, tile lists; 80 timed steps after a
    40-step warm-up; the peak device memory of a window build."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble

    sim = md_sim(dev, "2clr")
    if sim.grid is None or sim.agbnp.pair_tiles is None:
        raise AssertionError("[16] 2clr must run the cell grid and lists")
    ens = ReplicaEnsemble(sim, ENS_2CLR_REPLICAS)
    pos = ens.initial_states(jitter=1e-3)[0]
    ff = sim.ff_state()
    caps = sim._ensure_vdw_caps()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    sim.window_build(pos, ff, caps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[16] 2clr x {ENS_2CLR_REPLICAS}: a window build peaks at "
        f"{peak / 2**30:.3f} GiB allocated ({(peak - base) / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held before it) on {card}")
    _, counts = ensemble_run(dev, card, "[16]", sim, ENS_2CLR_REPLICAS,
                             ENS_2CLR_STEPS, ENS_WARMUP)
    torch.cuda.synchronize()
    return counts


def phase_remd(dev, card, sim, ens_window):
    """Phase 17: T-REMD of 8 x 1li2 on geometric_ladder(300, 450, 8), 40
    steps a cycle and a window, 2 warm-up cycles, then 5 timed (host clock
    around a synchronised run) between two timed ReplicaEnsemble runs of
    as many replicas in the same process (turns: ensemble, T-REMD,
    ensemble); then two profiled cycles beside [15]'s profiled R = 8
    window (ens_window: kernels and device ms a step); then an all-300 K
    ladder of 2 replicas, two cycles of 10 steps, against ReplicaEnsemble
    with the same generators, bitwise."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (ReplicaEnsemble,
                                               TemperatureREMD,
                                               geometric_ladder)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.remd import pair_acceptance

    ens_ms = [ensemble_run(dev, card, "[17] turn 1: ensemble", sim,
                           REMD_REPLICAS, REMD_ENS_STEPS, ENS_WARMUP)[0]]
    remd = TemperatureREMD(sim, geometric_ladder(*REMD_T, REMD_REPLICAS))
    run = remd.make_runner(steps_per_cycle=REMD_SPC, neighbor_every=REMD_SPC)
    states, xgen = remd.initial_states(jitter=1e-3)
    PK.reset_launch_counts()
    states, _ = run(states, xgen, REMD_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, out = run(states, xgen, REMD_CYCLES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = PK.launch_counts()
    steps = (REMD_WARM + REMD_CYCLES) * REMD_SPC
    check_every_step({k: v / steps for k, v in counts.items()},
                     ("born_sums_tiles", "gb_pair_tiles",
                      "descreening_tiles"), "[17]")
    rung_all = out["rung"].cpu().numpy()
    for c, rung in enumerate(rung_all):
        if sorted(rung.tolist()) != list(range(REMD_REPLICAS)):
            raise AssertionError(f"[17] cycle {c}: rungs {rung} are not a "
                                 "permutation")
    rates = pair_acceptance(out["accept"].cpu().numpy())
    if not (bool(torch.isfinite(out["U"]).all())
            and bool(torch.isfinite(out["energies"]).all())
            and ((rates >= 0) & (rates <= 1)).all()):
        raise AssertionError(f"[17] acceptances {rates} or energies")
    ms = elapsed * 1e3 / (REMD_CYCLES * REMD_SPC)
    log(f"[17] turn 2: T-REMD {REMD_REPLICAS} x 1li2, ladder {REMD_T}: "
        f"{REMD_CYCLES} cycles of {REMD_SPC} steps after {REMD_WARM}: "
        f"{ms:.3f} ms/step, {86.4 / ms:.3f} ns/day a replica on {card}; "
        f"pair acceptance {np.round(rates, 3).tolist()}; rungs after the "
        f"last cycle {rung_all[-1].tolist()}")
    ens_ms.append(ensemble_run(dev, card, "[17] turn 3: ensemble", sim,
                               REMD_REPLICAS, REMD_ENS_STEPS, 0)[0])
    log(f"[17] T-REMD ms/step over the ensemble's of the turns around it: "
        f"{ms / max(ens_ms):.3f}-{ms / min(ens_ms):.3f}")
    _, n, dms = device_kernels(lambda: run(states, xgen, 2))
    log(f"[17] two profiled cycles (three window builds, two exchanges): "
        f"{n / (2 * REMD_SPC):.0f} kernels a step, device "
        f"{dms / (2 * REMD_SPC):.3f} ms a step, against {ens_window[0]:.0f} "
        f"and {ens_window[1]:.3f} in [15]'s profiled R = {REMD_REPLICAS} "
        f"window (one build)")
    nrep, spc = 2, 10
    remd = TemperatureREMD(sim, [300.0] * nrep)
    states, xgen = remd.initial_states(jitter=1e-3, seed=17)
    pos0, vel0 = states[0].clone(), states[1].clone()
    (pos, vel, _, _), out = remd.make_runner(
        steps_per_cycle=spc, neighbor_every=spc)(states, xgen, 2)
    ens = ReplicaEnsemble(sim, nrep)
    (epos, evel, _), (e, *_) = ens.make_runner(neighbor_every=spc)(
        (pos0, vel0, ens.initial_states(seed=17)[2]), 2 * spc)
    same = (torch.equal(pos, epos) and torch.equal(vel, evel)
            and torch.equal(out["energies"], e))
    log(f"[17] all-300 K REMD (2 replicas, 2 cycles of {spc}) bitwise the "
        f"ensemble with the same generators: {same}; accepted "
        f"{out['accept'].cpu().numpy().astype(int).tolist()}")
    if not same or not bool(out["accept"][0].all()):
        raise AssertionError("[17] equal-temperature REMD differs from the "
                             "ensemble")
    return counts


def phase_scoring(dev, card):
    """Phase 18: ConformerScorer on 1li2, 16 poses, NoCutoff (the dense
    sweeps) and CutoffNonPeriodic 1 nm (the lists), against the Context
    one pose at a time; kernels a score call at B = 1 and B = 16; refine of
    4 poses; version 2 on the 264-atom fixture against the v2 Context."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (AGBNPForce, AGBNPParams,
                                               ConformerScorer, Context,
                                               NonbondedMethod,
                                               load_gaussvol_dat)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    def force_of(p, version=1):
        force = AGBNPForce()
        force.setVersion(version)
        for i in range(p.n):
            force.addParticle(p.radius[i], p.gamma[i], p.alpha[i],
                              p.charge[i], bool(p.ishydrogen[i]))
        return force

    d, p = system("1li2")
    poses = jittered(d.positions, SCORE_POSES, 18)
    path_counts = {}
    for method, kernels in (("NoCutoff", ("born_sums", "gb_pair",
                                          "descreening")),
                            ("CutoffNonPeriodic", ("born_sums_tiles",
                                                   "gb_pair_tiles",
                                                   "descreening_tiles"))):
        force = force_of(p)
        force.setNonbondedMethod(getattr(NonbondedMethod, method))
        scorer = ConformerScorer(force, d.positions, device=dev)
        res = scorer.score(poses, forces=True, details=True)
        ctx = Context(force, device=dev)
        worst_e = worst_f = 0.0
        for b in range(SCORE_POSES):
            ctx.setPositions(poses[b])
            e, f = ctx.getEnergyForces()
            worst_e = max(worst_e, abs(float(res["energy"][b]) - e) / abs(e))
            worst_f = max(worst_f, rel_err(res["force"][b], f)[0])
        calls = {}
        for nb in (1, SCORE_POSES):
            PK.reset_launch_counts()
            _, n, ms = device_kernels(lambda: scorer.score(poses[:nb]))
            calls[nb] = (n, ms, PK.launch_counts())
        log(f"[18] ConformerScorer 1li2 {method}, {SCORE_POSES} poses: vs "
            f"the Context energy rel {worst_e:.3e}, force max-err/max|f| "
            f"{worst_f:.3e}; a score call: B = 1 {calls[1][0]} kernels "
            f"({calls[1][1]:.3f} device ms), B = {SCORE_POSES} "
            f"{calls[SCORE_POSES][0]} kernels ({calls[SCORE_POSES][1]:.3f} "
            f"device ms) on {card}; pair kernels at B = {SCORE_POSES} "
            f"{pair_launches(calls[SCORE_POSES][2])}, take_rows "
            f"{calls[SCORE_POSES][2]['take_rows']}")
        if not (worst_e <= SCORE_TOL and worst_f <= SCORE_TOL):
            raise AssertionError(f"[18] {method}: scorer vs Context")
        check_once(calls[SCORE_POSES][2], kernels, f"[18] {method}")
        for k, v in calls[SCORE_POSES][2].items():
            path_counts[k] = path_counts.get(k, 0) + v
        if calls[SCORE_POSES][2]["take_rows"] < 1:
            raise AssertionError(f"[18] {method}: the tree's passes did not "
                                 "launch take_rows")
        total = res["e_cav"] + res["gb_self"] + res["gb_pair"] + res["e_vdw"]
        if rel_err(total, res["energy"])[0] > 1e-6:
            raise AssertionError("[18] details do not add up to the energy")
    e0 = scorer.score(poses[:REFINE_POSES])["energy"]
    ref = scorer.refine(poses[:REFINE_POSES], maxiter=REFINE_ITERS)
    drop = (e0 - ref["energy"]).cpu().numpy()
    log(f"[18] refine {REFINE_POSES} poses, {REFINE_ITERS} FIRE iterations: "
        f"energy drops {np.round(drop, 3).tolist()} kJ/mol")
    if not (drop > 0).all():
        raise AssertionError("[18] refine did not lower every energy")

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    force = force_of(p, version=2)
    poses = pos[None] + 0.005 * np.random.default_rng(19).standard_normal(
        (2,) + pos.shape)
    res = ConformerScorer(force, pos, device=dev).score(poses, forces=True)
    worst_e = worst_f = 0.0
    for b in range(2):
        ctx = Context(force, device=dev)
        ctx.setPositions(poses[b])
        e, f = ctx.getEnergyForces()
        worst_e = max(worst_e, abs(float(res["energy"][b]) - e) / abs(e))
        worst_f = max(worst_f, rel_err(res["force"][b], f)[0])
    log(f"[18] v2 scorer, 2 poses of the 264-atom fixture vs the v2 Context: "
        f"energy rel {worst_e:.3e}, force max-err/max|f| {worst_f:.3e}")
    if not (worst_e <= SCORE_TOL and worst_f <= SCORE_TOL):
        raise AssertionError("[18] v2 scorer vs Context")
    torch.cuda.synchronize()
    return path_counts


GRAD_POSES = 4        # [19] 1li2 poses (numpy seed)
GRAD_JITTER = 0.005   # nm, as the JAX package's fitting test
FD_RTOL, FD_ATOL = 5e-6, 1e-8  # JAX's tests/test_fitting.py bar
GRAD_F32_TOL = 1e-4   # of max|g| per key, f32 gradients vs f64
CONS_REPLICAS = 8     # [20] 1li2 replicas with X-H constraints
CONS_WARMUP, CONS_STEPS = 40, 80
CONS_E_TOL = 1e-5     # relative, replica 0 of R = 8 vs R = 1 at every step
CONS_REMD_CYCLES = 2  # [20] T-REMD cycles of NEIGHBOR_EVERY steps
PER_STEP_REPLICAS, PER_STEP_STEPS = 4, 20  # [21]
FIRST_STEP_TOL = 1e-5  # relative, [21]-[22] first steps against each other
VSITE_REPLICAS, VSITE_STEPS = 4, 20  # [21] trp-cage with hydration sites
OPTION_STEPS = 40     # [22]
NO_MM_TOL = 1e-6      # relative, include_mm=False vs the model's energy
TOPOLOGY_RELAX = 0.5  # [22]


def phase_param_grads(dev, card):
    """Phase 19: ParameterGradients on 1li2 (full width, NoCutoff, the
    plain pair route) in f64 and f32 on the card: 4 poses jittered 0.005
    nm (numpy seed); gamma, alpha and charge gradients against central
    finite differences along a random direction (JAX's bar), the
    hydrogens' gamma gradients exactly 0, f32 against f64; take_rows
    launched in the forward; the backward under
    torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, ParameterGradients
    from openmm_agbnp_plugin_tpu_torch.api.fitting import FITTABLE
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system("1li2")
    rng = np.random.default_rng(19)
    poses = np.asarray(d.positions)[None] + GRAD_JITTER * \
        rng.standard_normal((GRAD_POSES,) + np.asarray(d.positions).shape)
    grads, pgs, path_counts = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        m = AGBNPModel(p, device=dev, dtype=dtype, version=1,
                       pair_kernel=False, positions=d.positions)
        pg = pgs[dtype] = ParameterGradients(m)
        theta = pg.initial_theta()
        PK.reset_launch_counts()
        out = pg.energy_grads(theta, poses)
        torch.cuda.synchronize()
        counts = PK.launch_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        t0 = time.perf_counter()
        out = pg.energy_grads(theta, poses)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads[dtype] = out
        log(f"[19] ParameterGradients 1li2 {str(dtype)[6:]}, {GRAD_POSES} "
            f"poses, gamma/alpha/charge: {ms:.1f} ms an energy_grads call "
            f"on {card}; take_rows launches a call "
            f"{counts['take_rows']}, pair kernels {pair_launches(counts)}")
        if counts["take_rows"] < 1:
            raise AssertionError("[19] the forward launched no take_rows")
        if pair_launches(counts):
            raise AssertionError("[19] the plain route launched a pair "
                                 "kernel")
    g64, pg = grads[torch.float64], pgs[torch.float64]
    theta = pg.initial_theta()
    hyd = torch.as_tensor(np.asarray(p.ishydrogen) > 0, device=dev)
    if bool((g64["gamma"][:, hyd] != 0).any()):
        raise AssertionError("[19] hydrogen gamma gradients are not 0")
    for key in FITTABLE:
        direction = torch.as_tensor(rng.standard_normal(p.n), device=dev)
        h = 1e-5 * max(1.0, float(theta[key].abs().max()))
        ep = pg.energies({key: theta[key] + h * direction}, poses)
        em = pg.energies({key: theta[key] - h * direction}, poses)
        fd = ((ep - em) / (2 * h)).cpu().numpy()
        an = (g64[key] @ direction).cpu().numpy()
        worst = np.max(np.abs(an - fd) / (FD_ATOL + FD_RTOL * np.abs(fd)))
        g32 = grads[torch.float32][key].double()
        err32 = rel_err(g32, g64[key])[0]
        log(f"[19] {key}: analytic {np.round(an, 6).tolist()} vs central "
            f"differences {np.round(fd, 6).tolist()} (h {h:.1e}): worst "
            f"|diff| / (atol + rtol |fd|) {worst:.3f}; f32 vs f64 "
            f"max-err/max|g| {err32:.3e}")
        if not worst <= 1.0:
            raise AssertionError(f"[19] {key}: gradient vs finite "
                                 "differences")
        if not err32 <= GRAD_F32_TOL:
            raise AssertionError(f"[19] {key}: f32 gradient vs f64")
    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    pos = torch.as_tensor(poses[:1], dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energy = pg._energy(leaves, pos)[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        back = torch.autograd.grad(energy, list(leaves.values()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = all(torch.equal(b, g64[k][0]) for b, k in zip(back, leaves))
    log(f"[19] one pose, f64: forward {(t1 - t0) * 1e3:.1f} ms, backward "
        f"{(t2 - t1) * 1e3:.1f} ms (host clock, synchronised); the "
        f"backward ran with no host sync; its gradients bitwise "
        f"energy_grads' pose 0: {same}")
    if not same:
        raise AssertionError("[19] the backward is not repeatable")
    torch.cuda.synchronize()
    return path_counts


def constraint_violations(sim, pos):
    """Every replica's worst relative X-H distance error, numpy [R]."""
    return sim.constraints.max_violation(pos).cpu().numpy()


def phase_constrained_replicas(dev, card):
    """Phase 20: 8 x 1li2 with X-H constraints (SHAKE/RATTLE per replica),
    strict 1 fs on the lists, 40-step windows: ReplicaEnsemble at R = 1
    and R = 8 in turns (40 warm-up then 80 timed steps continuing them),
    replica 0 of R = 8 against the R = 1 run from the same state and
    generator at every step, every replica's constraint violation within
    the f32 tolerance, #5-#7 every step; then TemperatureREMD with
    constraints, 2 cycles of 40 on geometric_ladder(300, 450, 8)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (ReplicaEnsemble,
                                               TemperatureREMD,
                                               geometric_ladder)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        replica_generators, worst_replica

    sim = md_sim(dev, "1li2", constraints=True)
    cons = sim.constraints
    tol = cons.tolerance(torch.float32)
    if cons.n_constraints != 665 or cons.clusters is None:
        raise AssertionError(f"[20] {cons.n_constraints} constraints")
    ens8 = ReplicaEnsemble(sim, CONS_REPLICAS)
    pos8, vel8, gens8 = ens8.initial_states(jitter=1e-3)
    starts = {CONS_REPLICAS: (pos8, vel8, gens8),
              1: (pos8[:1].clone(), vel8[:1].clone(),
                  replica_generators(dev, 1, 0))}
    energies, ms, path_counts = {}, {}, {}
    for nrep in (1, CONS_REPLICAS):
        run = ReplicaEnsemble(sim, nrep).make_runner(
            neighbor_every=NEIGHBOR_EVERY)
        PK.reset_launch_counts()
        states, (e0, *d0) = run(starts[nrep], CONS_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, (e1, *d1) = run(states, CONS_STEPS)
        torch.cuda.synchronize()
        ms[nrep] = (time.perf_counter() - t0) * 1e3 / CONS_STEPS
        counts = PK.launch_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        nsteps = CONS_WARMUP + CONS_STEPS
        energies[nrep] = torch.cat([e0, e1], dim=1).double().cpu().numpy()
        viol = constraint_violations(sim, states[0])
        shake = max(float(d0[4].max()), float(d1[4].max()))
        report = sim.overflow_report(*worst_replica(d1))
        per_step = {k: round(v / nsteps, 3)
                    for k, v in pair_launches(counts).items()}
        log(f"[20] 1li2 x {nrep} with {cons.n_constraints} X-H constraints "
            f"a replica: {ms[nrep]:.3f} ms/step ({86.4 / ms[nrep]:.3f} "
            f"ns/day a replica, {86.4 * nrep / ms[nrep]:.3f} aggregate) on "
            f"{card}; worst violation {viol.max():.3e}, SHAKE residual "
            f"{shake:.3e} (tolerance {tol:.3e}); pair kernel launches a "
            f"step {per_step}")
        if report or energies[nrep].shape != (nrep, nsteps) \
                or not np.isfinite(energies[nrep]).all():
            raise AssertionError(f"[20] R = {nrep}: overflow {report}")
        if not (viol <= tol).all() or not shake <= tol:
            raise AssertionError(f"[20] R = {nrep}: constraint violation "
                                 f"{viol} over {tol}")
        check_every_step({k: v / nsteps for k, v in counts.items()},
                         ("born_sums_tiles", "gb_pair_tiles",
                          "descreening_tiles"), f"[20] R = {nrep}")
    e1, e8 = energies[1][0], energies[CONS_REPLICAS][0]
    worst = float(np.max(np.abs(e8 - e1) / np.abs(e1)))
    log(f"[20] replica 0 of R = {CONS_REPLICAS} vs the R = 1 run from the "
        f"same state and generator: worst relative energy difference over "
        f"{len(e1)} steps {worst:.3e}; R = {CONS_REPLICAS} over R = 1 ms/step "
        f"{ms[CONS_REPLICAS] / ms[1]:.3f}")
    if not worst <= CONS_E_TOL:
        raise AssertionError("[20] replica 0 of the batch differs from R = 1")
    remd = TemperatureREMD(sim, geometric_ladder(*REMD_T, CONS_REPLICAS))
    run = remd.make_runner(steps_per_cycle=NEIGHBOR_EVERY,
                           neighbor_every=NEIGHBOR_EVERY)
    states, xgen = remd.initial_states(jitter=1e-3)
    PK.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, out = run(states, xgen, CONS_REMD_CYCLES)
    torch.cuda.synchronize()
    steps = CONS_REMD_CYCLES * NEIGHBOR_EVERY
    rms = (time.perf_counter() - t0) * 1e3 / steps
    counts = PK.launch_counts()
    for k, v in counts.items():
        path_counts[k] = path_counts.get(k, 0) + v
    viol = constraint_violations(sim, states[0])
    rungs = out["rung"].cpu().numpy()
    log(f"[20] T-REMD {CONS_REPLICAS} x 1li2 with constraints, "
        f"{CONS_REMD_CYCLES} cycles of {NEIGHBOR_EVERY}: {rms:.3f} ms/step "
        f"(the first cycle included) on {card}; rungs {rungs.tolist()}, "
        f"worst violation {viol.max():.3e}, SHAKE residual "
        f"{float(out['shake_residual'].max()):.3e}")
    if not (viol <= tol).all() or any(sorted(r.tolist()) != list(range(
            CONS_REPLICAS)) for r in rungs):
        raise AssertionError("[20] T-REMD with constraints")
    check_every_step({k: v / steps for k, v in counts.items()},
                     ("born_sums_tiles", "gb_pair_tiles",
                      "descreening_tiles"), "[20] T-REMD")
    torch.cuda.synchronize()
    return path_counts


def trpcage_sites():
    """tests/test_torch_replica_md.py's two hydration sites on trp-cage:
    the NH2 hydrogens 212 and 213 on the axes from N 201 to their
    hydrogen-bond acceptors (O 60, N 179), at their N-H distances."""
    from openmm_agbnp_plugin_tpu_torch import HydrationSites

    hs = HydrationSites()
    hs.add_hydrogen_bonding_site(212, heavy=201, hydrogen=60,
                                 distance=0.0370)
    hs.add_hydrogen_bonding_site(213, heavy=201, hydrogen=179,
                                 distance=0.0355)
    return hs.virtual_sites()


def phase_per_step(dev, card):
    """Phase 21: ReplicaEnsemble.make_runner(neighbor_every=0) on 4 x
    1li2, 20 steps, its first step against the windowed runner's from the
    same state (both evaluate a fresh build there); then a 20-step
    ensemble window of 4 trp-cage replicas with two hydration sites: the
    sites on their parents' axis, their forces 0 after the spread."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.md.vsites import project_positions
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        replica_generators, worst_replica

    sim = md_sim(dev, "1li2")
    ens = ReplicaEnsemble(sim, PER_STEP_REPLICAS)
    pos, vel, _ = ens.initial_states(jitter=1e-3)
    path_counts = {}
    first = {}
    for every, steps in ((NEIGHBOR_EVERY, 1), (0, PER_STEP_STEPS)):
        states = (pos.clone(), vel.clone(),
                  replica_generators(dev, PER_STEP_REPLICAS, 0))
        PK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, (e, *diag) = ens.make_runner(neighbor_every=every)(states, steps)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        first[every] = e[:, 0].double().cpu().numpy()
        if every == 0:
            counts = PK.launch_counts()
            path_counts = counts
            report = sim.overflow_report(*worst_replica(diag))
            log(f"[21] per-step path, {PER_STEP_REPLICAS} x 1li2: "
                f"{elapsed * 1e3 / steps:.3f} ms/step on {card} (a tree build "
                f"a step over the all-pairs candidates); overflow "
                f"{bool(report)}; pair kernel launches "
                f"{pair_launches(counts)}")
            if report or not bool(torch.isfinite(e).all()):
                raise AssertionError(f"[21] per-step path: {report}")
            check_every_step({k: v / steps for k, v in counts.items()},
                             ("born_sums_tiles", "gb_pair_tiles",
                              "descreening_tiles"), "[21]")
    worst = float(np.max(np.abs(first[0] - first[NEIGHBOR_EVERY])
                         / np.abs(first[NEIGHBOR_EVERY])))
    log(f"[21] first step, per-step vs windowed runner: worst relative "
        f"energy difference {worst:.3e}")
    if not worst <= FIRST_STEP_TOL:
        raise AssertionError("[21] the per-step path's first step differs")

    vs_table = trpcage_sites()
    vsim = md_sim(dev, "trpcage", vsites=vs_table)
    vs = vsim.vsites
    vens = ReplicaEnsemble(vsim, VSITE_REPLICAS)
    PK.reset_launch_counts()
    (vpos, _, _), (ve, *vdiag) = vens.make_runner(
        neighbor_every=VSITE_STEPS)(vens.initial_states(jitter=1e-3),
                                    VSITE_STEPS)
    for k, v in PK.launch_counts().items():
        path_counts[k] = path_counts.get(k, 0) + v
    proj = project_positions(vpos, vs)
    want = (vs["w1"][:, None] * vpos[:, vs["p1"]]
            + vs["w2"][:, None] * vpos[:, vs["p2"]])
    each = all(torch.equal(proj[r], project_positions(vpos[r], vs))
               for r in range(VSITE_REPLICAS))
    force = vsim.force_fn()(vpos)[1]
    site_f = float(force[:, vs["site"]].abs().max())
    report = vsim.overflow_report(*worst_replica(vdiag))
    log(f"[21] trp-cage x {VSITE_REPLICAS} with {len(vs_table.site)} "
        f"hydration sites, {VSITE_STEPS} steps: sites at w1 p1 + w2 p2 "
        f"{torch.equal(proj[:, vs['site']], want)}, each replica's "
        f"projection bitwise its own {each}, site forces after the spread "
        f"max {site_f}; overflow {bool(report)}")
    if not (torch.equal(proj[:, vs["site"]], want) and each
            and site_f == 0.0 and not report
            and bool(torch.isfinite(ve).all())):
        raise AssertionError("[21] virtual sites in the replica runner")
    torch.cuda.synchronize()
    return path_counts


def phase_options(dev, card):
    """Phase 22: the Simulation options.  1li2 with pair_kernel=False in
    f64 on the card against the f32 kernel route at the same positions
    (energy and forces), then 40 steps after an equal warm-up;
    include_mm=False against the model's own energy; topology_relax=0.5:
    a 40-step window with no overflow (regrown if the birth-margin rows
    need room), its first step against relax=None's."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    from openmm_agbnp_plugin_tpu_torch import Simulation

    d, _ = system("1li2")
    sim32 = md_sim(dev, "1li2")
    sim64 = Simulation(d, device=dev, version=1, cutoff=1.0,
                       dtype=torch.float64, skin=0.25,
                       descreen_horizon="cutoff", pair_kernel=False)
    e32, f32_, _ = sim32.force_fn()(sim32.positions)
    e64, f64_, _ = sim64.force_fn()(sim64.positions)
    e_rel = abs(float(e32) - float(e64)) / abs(float(e64))
    f_rel = rel_err(f32_, f64_)[0]
    log(f"[22] 1li2 pair_kernel=False in f64 on the card vs the f32 kernel "
        f"route: energy {float(e64):.6f} / {float(e32):.6f}, relative "
        f"{e_rel:.3e}; forces max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= FIRST_STEP_TOL and f_rel <= FIRST_STEP_TOL):
        raise AssertionError("[22] f64 plain route vs the f32 kernels")
    _, counts64, _ = run_md(dev, card, "1li2", OPTION_STEPS, "[22] f64 "
                            "pair_kernel=False", sim=sim64)
    if pair_launches(counts64):
        raise AssertionError("[22] the plain route launched a pair kernel")

    no_mm = md_sim(dev, "1li2", include_mm=False)
    e_sim = float(no_mm.force_fn()(no_mm.positions)[0])
    e_model = float(no_mm.agbnp.energy_forces(no_mm.positions)[0])
    rel = abs(e_sim - e_model) / abs(e_model)
    log(f"[22] include_mm=False: Simulation energy {e_sim:.6f} vs the "
        f"model's AGBNP energy {e_model:.6f}, relative {rel:.3e}")
    if not rel <= NO_MM_TOL:
        raise AssertionError("[22] include_mm=False energy")

    sim = md_sim(dev, "1li2")
    regrows = 0
    PK.reset_launch_counts()
    while True:
        run = sim.make_langevin_runner(
            0.001, 300.0, 1.0, neighbor_every=OPTION_STEPS,
            topology_relax=TOPOLOGY_RELAX)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, e_rel_run, diag = run(
            sim.positions, sim.velocities, OPTION_STEPS,
            generator=torch.Generator(device=dev).manual_seed(22))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        report = sim.overflow_report(*diag)
        if not report or regrows == 3:
            break
        log(f"[22] topology_relax={TOPOLOGY_RELAX}: the window overflowed "
            f"{report}; PanicButton regrow")
        sim._regrow(*diag)
        regrows += 1
    counts = PK.launch_counts()
    _, _, e_plain, _ = sim.make_langevin_runner(
        0.001, 300.0, 1.0, neighbor_every=OPTION_STEPS)(
            sim.positions, sim.velocities, 1,
            generator=torch.Generator(device=dev).manual_seed(22))
    first = abs(float(e_rel_run[0]) - float(e_plain[0])) / abs(
        float(e_plain[0]))
    log(f"[22] topology_relax={TOPOLOGY_RELAX}: {OPTION_STEPS}-step window "
        f"after {regrows} regrows, overflow {bool(report)}, "
        f"{elapsed * 1e3 / OPTION_STEPS:.3f} ms/step on {card}; first step "
        f"vs relax=None's: relative {first:.3e}; tree rows "
        f"{sim.agbnp.caps.caps}")
    if report or first > FIRST_STEP_TOL \
            or not np.isfinite(e_rel_run.cpu().numpy()).all():
        raise AssertionError("[22] topology_relax window")
    for k, v in counts64.items():
        counts[k] = counts.get(k, 0) + v
    torch.cuda.synchronize()
    return counts


# [23]-[25]: the batched AGBNP2 evaluation and the synthetic ball
SCORE_V2_POSES = 8        # [23] 1li2 poses (numpy seed)
SCORE_V2_JITTER = 0.005   # nm
PER_STEP_V2_REPLICAS = 4  # [24] 1li2 replicas, against one
PER_STEP_V2_WARMUP = 2    # [24] steps before the timed ones
PER_STEP_V2_STEPS = 10    # [24] timed steps
V2_ENS_E_TOL = 1e-5       # relative, replica 0 of R = 4 vs R = 1, each step
SYNTH_ATOMS = 10240       # [25] bench.py's synth10k leg
# [25] run_md's nsteps: 4 heat and 4 timed windows of SYNTH_EVERY steps.
# bench.py runs 400, but the ball's dynamics blow up near step 200 on the
# card: its potential falls ~3e6 kJ/mol in the first 180 steps and heats
# it to ~2e4 K, and the f64 plain route replays the same blow-up
# (profile_port_step.py --synth-trace); 160 ends two windows before it
SYNTH_STEPS = 160
SYNTH_EVERY = 20          # [25] rebuild windows (bench.py's run_md)
SYNTH_F_TOL = 1e-4        # [25] f32 lists vs f64 plain, of max|f|
V2_KERNELS = ("born_sums", "gb_pair", "descreening")
LIST_KERNELS = ("born_sums_tiles", "gb_pair_tiles", "descreening_tiles")


def agbnp_force(p, version):
    """An AGBNPForce of the particle table p at the given version."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce

    force = AGBNPForce()
    force.setVersion(version)
    for i in range(p.n):
        force.addParticle(p.radius[i], p.gamma[i], p.alpha[i], p.charge[i],
                          bool(p.ishydrogen[i]))
    return force


def phase_score_v2(dev, card):
    """Phase 23: ConformerScorer version 2 on 1li2 (f32, NoCutoff, the
    dense kernels #1-#3 with the replica axis), 8 poses jittered 0.005 nm
    (numpy seed): each pose against its own B = 1 score (energy 1e-6
    relative, forces 1e-5 of max|f|), against the port's f64 scorer on the
    card (energy 1e-5 relative, forces 1e-4 of max|f|), #1-#3 launched
    once a call, two calls bitwise equal; kernels and device ms of a call
    at B = 8 and B = 1, and the peak memory of the B = 8 call.  Returns
    the launches of the counted call."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import ConformerScorer
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system("1li2")
    force = agbnp_force(p, 2)
    nb = SCORE_V2_POSES
    poses = np.asarray(d.positions)[None] + SCORE_V2_JITTER * \
        np.random.default_rng(23).standard_normal(
            (nb,) + np.asarray(d.positions).shape)
    scorer = ConformerScorer(force, d.positions, device=dev)
    m = scorer.model
    sized = (m.cap_ms, m.ms_kmax, scorer._ms_kmax_list)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = scorer.score(poses, forces=True, details=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    m = scorer.model
    PK.reset_launch_counts()
    again = scorer.score(poses, forces=True)
    counts = PK.launch_counts()
    bitwise = (torch.equal(again["energy"], res["energy"])
               and torch.equal(again["force"], res["force"]))
    log(f"[23] v2 scorer, {nb} poses of 1li2 (f32, NoCutoff): the first "
        f"score (its regrows included) {first_s:.3f} s, peak "
        f"{peak / 1e9:.3f} GB allocated ({(peak - base) / 1e9:.3f} GB above "
        f"the {base / 1e9:.3f} GB held before it) on {card}; (cap_ms, "
        f"MS-tree width, candidate width) {sized} -> "
        f"{(m.cap_ms, m.ms_kmax, scorer._ms_kmax_list)}; launches of a "
        f"call {pair_launches(counts)}, take_rows {counts['take_rows']}; "
        f"two calls bitwise equal {bitwise}")
    check_once(counts, V2_KERNELS, "[23]")
    if not bitwise or counts["take_rows"] < 1:
        raise AssertionError("[23] scorer calls differ, or no take_rows")
    total = sum(res[k] for k in ("e_vol1", "e_vol2", "e_ms_vdw", "gb_self",
                                 "gb_pair", "e_vdw", "e_ms_large"))
    if not (bool(torch.isfinite(res["force"]).all())
            and rel_err(total, res["energy"])[0] <= 1e-6):
        raise AssertionError("[23] non-finite forces, or details off")

    worst_e = worst_f = 0.0
    for b in range(nb):
        one = scorer.score(poses[b], forces=True)
        e1 = float(one["energy"][0])
        worst_e = max(worst_e, abs(float(res["energy"][b]) - e1) / abs(e1))
        worst_f = max(worst_f, rel_err(res["force"][b], one["force"][0])[0])
    ref = ConformerScorer(force, d.positions, dtype=torch.float64,
                          device=dev)
    e64, f64 = [], []
    for s in range(0, nb, 2):  # two poses a call keep the f64 peak low
        r = ref.score(poses[s:s + 2], forces=True)
        e64.append(r["energy"])
        f64.append(r["force"])
    e64, f64 = torch.cat(e64), torch.cat(f64)
    e_rel = float(torch.max(torch.abs(res["energy"].double() - e64)
                            / torch.abs(e64)))
    f_rel = max(rel_err(res["force"][b], f64[b])[0] for b in range(nb))
    del ref
    log(f"[23] each pose vs its own B = 1 score: energy rel {worst_e:.3e}, "
        f"force max-err/max|f| {worst_f:.3e}; f32 vs the port's f64 scorer "
        f"on the card: energy rel {e_rel:.3e}, force {f_rel:.3e}")
    if not (worst_e <= BATCH_E_TOL and worst_f <= BATCH_F_TOL):
        raise AssertionError("[23] a pose differs from its B = 1 score")
    if not (e_rel <= PARITY_TOL and f_rel <= V2_FORCE_TOL):
        raise AssertionError("[23] f32 scorer vs f64")
    calls = {}
    for k in (1, nb):
        _, n, ms = device_kernels(
            lambda k=k: scorer.score(poses[:k], forces=True))
        calls[k] = (n, ms)
    log(f"[23] a score call: B = 1 {calls[1][0]} kernels "
        f"({calls[1][1]:.3f} device ms), B = {nb} {calls[nb][0]} kernels "
        f"({calls[nb][1]:.3f} device ms) on {card}")
    torch.cuda.synchronize()
    return counts


def phase_per_step_v2(dev, card):
    """Phase 24: ReplicaEnsemble of 1li2 in version 2 on the per-step
    path (make_runner(neighbor_every=0): one batched AGBNP2 evaluation a
    step, each replica's MS candidates found on the card), f32, R = 1 and
    R = 4 fed the same noise (numpy seed) from the same states, 2 warm-up
    steps then 10 timed: replica 0 of R = 4 within 1e-5 in energy of R = 1
    at every step, finite energies, no overflow, #1-#3 every step; the
    windowed runner and T-REMD refuse version 2.  Returns the launches of
    both runs."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (ReplicaEnsemble, Simulation,
                                               TemperatureREMD)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.models.capacity import WindowDiag
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica
    from openmm_agbnp_plugin_tpu_torch.parallel.remd import geometric_ladder

    d, _ = system("1li2")
    sim = Simulation(d, device=dev, version=2, cutoff=1.0,
                     dtype=torch.float32, skin=0.25)
    nrep, warm, steps = (PER_STEP_V2_REPLICAS, PER_STEP_V2_WARMUP,
                         PER_STEP_V2_STEPS)
    n = sim.positions.shape[0]
    rng = np.random.default_rng(24)
    pos0 = sim.positions[None] + torch.as_tensor(
        1e-3 * rng.standard_normal((nrep, n, 3)), dtype=torch.float32,
        device=dev)
    vel0 = sim.velocities.expand(nrep, n, 3).clone()
    noise = torch.as_tensor(rng.standard_normal((warm + steps, nrep, n, 3)),
                            dtype=torch.float32, device=dev)
    # JAX's MS-tree neighbor width (64) is short for 1li2: grow the
    # capacities on one step of the replicas first
    for _ in range(4):
        _, (_, *diag) = ReplicaEnsemble(sim, nrep).make_runner(
            neighbor_every=0)((pos0.clone(), vel0.clone(), None), 1,
                              noise=noise)
        report = sim.overflow_report(*worst_replica(diag))
        if not report:
            break
        log(f"[24] per-step v2: overflow {report}; PanicButton regrow")
        sim._regrow(*worst_replica(diag))
    runs, path_counts = {}, {}
    for r in (1, nrep):
        run = ReplicaEnsemble(sim, r).make_runner(neighbor_every=0)
        PK.reset_launch_counts()
        states, (e_w, *diag_w) = run((pos0[:r].clone(), vel0[:r].clone(),
                                      None), warm, noise=noise[:warm, :r])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, (e_t, *diag_t) = run(states, steps, noise=noise[warm:, :r])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = PK.launch_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        report = sim.overflow_report(*worst_replica(
            WindowDiag(*diag_w).merge(diag_t)))
        energies = torch.cat([e_w, e_t], dim=1).double().cpu()
        runs[r] = energies
        log(f"[24] per-step v2, R = {r} x 1li2: {ms:.3f} ms/step, "
            f"{86.4 / ms * r:.3f} ns/day aggregate (1 fs steps) on {card}; "
            f"overflow {bool(report)}; pair kernel "
            f"launches {pair_launches(counts)} in {warm + steps} steps")
        if report or not bool(torch.isfinite(energies).all()) \
                or not bool(torch.isfinite(states[0]).all()):
            raise AssertionError(f"[24] R = {r}: {report} or non-finite")
        check_every_step({k: counts[k] / (warm + steps) for k in V2_KERNELS},
                         V2_KERNELS, f"[24] R = {r}")
    worst = float(torch.max(torch.abs(runs[nrep][0] - runs[1][0])
                            / torch.abs(runs[1][0])))
    log(f"[24] replica 0 of R = {nrep} vs R = 1 over {warm + steps} steps: "
        f"worst relative energy difference {worst:.3e}")
    if not worst <= V2_ENS_E_TOL:
        raise AssertionError("[24] replica 0 of the batch differs")
    for what, make in (("the windowed runner", lambda: ReplicaEnsemble(
            sim, 2).make_runner(neighbor_every=20)),
                       ("T-REMD", lambda: TemperatureREMD(
                           sim, geometric_ladder(300.0, 450.0, 4)))):
        try:
            make()
        except NotImplementedError as exc:
            log(f"[24] {what} refuses version 2: {exc}")
        else:
            raise AssertionError(f"[24] {what} took version 2")
    torch.cuda.synchronize()
    return path_counts


def window_evaluation(sim, pos):
    """Energy and forces at pos through what a rebuild window runs: the
    window's neighbor list and tree topology built at pos (the full WU
    pass), then the Simulation's force function over them; and the
    build's overflow report."""
    ff = sim.ff_state()
    pairs, topo, _, (bcounts, nbmax, sibs, _) = sim.window_build(pos[None],
                                                                 ff)
    e, f, _ = sim.force_fn(pairs=pairs, topology=topo, ff=ff)(pos)
    return e, f, sim.overflow_report(bcounts[0], nbmax[0], sibs[0])


def phase_synthetic(dev, card):
    """Phase 25: bench.py's synth10k leg on the port: utils/synthetic.py's
    run_md(10240, nsteps=SYNTH_STEPS) (the bonded synthetic ball, AGBNP1 +
    the MM force field, CutoffNonPeriodic 1 nm, f32, the cell grid and tile
    lists, rebuilds every 20 steps) through the reference's windowed
    protocol: 4 heat windows from 300 K, shrink-to-fit if they regrew, then
    the timed windows, every overflowed window regrown and retried.
    Finite energies in the last window, no overflow left, #5-#7 once a
    step run (retries and heat windows included) and the tree kernels at
    every level; then one evaluation at the final positions against the port's
    f64 pair_kernel=False route on the card, sized at those positions
    (energy 1e-5 relative, forces 1e-4 of max|f|).  Returns the launches
    of the MD run."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.utils.synthetic import run_md as \
        synth_md

    PK.reset_launch_counts()
    r = synth_md(SYNTH_ATOMS, nsteps=SYNTH_STEPS, device=dev,
                 neighbor_every=SYNTH_EVERY)
    counts = PK.launch_counts()
    check_windowed_md(r, counts, card, "[25]")
    e32, f32, rep32 = window_evaluation(r["sim"], r["final_pos"])
    pos = r["final_pos"].double().cpu().numpy()
    del r
    torch.cuda.empty_cache()
    f64_against(dev, pos, e32, f32, rep32, "[25]")
    torch.cuda.synchronize()
    return counts


def check_windowed_md(r, counts, card, label, qd_shared=True):
    """Log a synthetic.run_md result of the windowed protocol (heat and
    timed windows, regrows by channel, the capacities after shrink-to-fit,
    the clean windows' median ms/step and ns/day, steps done and run, each
    clean window's last energy and kinetic temperature) and check it: no
    overflow, finite energies in the last window, the cell
    grid and tile lists on, #5-#7 launched once a step run (#7 recomputing
    where the lists' Q/dQ are not shared) and the tree kernels at every
    level of both passes of every step run."""
    import numpy as np

    sim, e = r["sim"], r["energies"]
    heat = r["steps_done"] // SYNTH_EVERY - r["windows"]
    log(f"{label} run_md({r['natoms']}), f32, 1 nm, windowed: "
        f"{r['ns_day']:.3f} ns/day ({r['ms_step']:.3f} ms/step, the median "
        f"of {r['windows']} clean timed windows) on {card}; set-up "
        f"{r['init_s']:.1f} s; {heat} heat windows; regrows {r['regrows']} "
        f"{[(w, sorted(rep)) for w, rep in r['regrow_log']]}; shrink-to-fit "
        f"{r['shrunk']}; steps done {r['steps_done']}, run "
        f"{r['steps_run']}; overflow {r['overflow']}; cell grid "
        f"{sim.grid is not None}, kmax {sim.kmax}, pair_tiles "
        f"{sim.agbnp.pair_tiles}, tree rows {sim.agbnp.caps.caps}, offs "
        f"{sim.agbnp.caps.offs}; last window E first/last "
        f"{e[0]:.2f}/{e[-1]:.2f}; launches {pair_launches(counts)}, "
        f"tree kernels { {k: counts[k] for k in TREE_KERNELS} }")
    log(f"{label} clean windows (label, last E, K): "
        f"{[(w[0], round(w[2], 1), round(w[3], 1)) for w in r['window_log']]}")
    if r["overflow"] or e.shape != (SYNTH_EVERY,) or \
            not np.isfinite(e).all():
        raise AssertionError(f"{label} overflow or non-finite energies")
    if sim.grid is None or sim.agbnp.pair_tiles is None:
        raise AssertionError(f"{label} the ball must run the cell grid, "
                             "lists")
    check_list_launches(counts, r["steps_run"], label, qd_shared=qd_shared)
    # the cavity and the WU pass every step run
    check_tree_launches(counts, 2 * r["steps_run"], label)


def f64_against(dev, pos, e32, f32, rep32, label):
    """The ball's f32 evaluation at pos against the port's f64
    pair_kernel=False route on the card, its Simulation sized at pos
    (energy PARITY_TOL relative, forces SYNTH_F_TOL of max|f|); neither
    window build may overflow."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation
    from openmm_agbnp_plugin_tpu_torch.utils.synthetic import synthetic_dms

    dms = synthetic_dms(pos.shape[0])
    dms.positions = pos
    sim64 = Simulation(dms, device=dev, version=1, cutoff=1.0,
                       dtype=torch.float64, pair_kernel=False)
    e64, f64, rep64 = window_evaluation(sim64, sim64.positions)
    del sim64
    torch.cuda.empty_cache()
    e_rel = abs(float(e32) - float(e64)) / abs(float(e64))
    f_rel = rel_err(f32, f64)[0]
    log(f"{label} one evaluation at the final positions, f32 kernels vs f64 "
        f"pair_kernel=False on the card: energy {float(e32):.4f} / "
        f"{float(e64):.4f}, relative {e_rel:.3e}; forces max-err/max|f| "
        f"{f_rel:.3e}; builds' overflow {rep32 or None} / {rep64 or None}")
    if rep32 or rep64 or not (e_rel <= PARITY_TOL and f_rel <= SYNTH_F_TOL):
        raise AssertionError(f"{label} f32 vs f64 on the ball")


NATIVE_GOLDEN = (-2476.66, 872.514, 0.0874992, 0.0886249)  # E, E_cav, dE, pred
NATIVE_DE_TOL = 1e-6  # kJ/mol, the displacement check (tests/test_native.py)
# [27]: the examples' sizes on the card (AGBNP_TEST_* as the JAX package's
# tests/test_example.py sets them, the drift bar off: 0.05 ps of an
# unequilibrated state says nothing of energy conservation)
EXAMPLE_ENV = dict(AGBNP_TEST_LANGEVIN_STEPS="200",
                   AGBNP_TEST_VERLET_STEPS="100",
                   AGBNP_TEST_MINIMIZE_ITERS="20",
                   AGBNP_TEST_DRIFT_TOL="1e9")
EXAMPLE_POSES, EXAMPLE_REPS = 64, 5       # rescore_conformers' defaults
EXAMPLE_REMD = (2, 40)                    # remd_trpcage: cycles, steps
EXAMPLE_MD_STEPS, EXAMPLE_RANKS = 20, 2   # multichip_md on one card
# [28]: trp-cage v1 f64 atoms-mesh MD (JAX test_parallel.py:144-164: 12
# steps in windows of 6, seed 7, rtol 1e-12 / atol 1e-9 on the energies,
# atol 1e-12 nm on the positions), then SHARD_TIMED steps timed
SHARD_RANKS, SHARD_STEPS, SHARD_EVERY, SHARD_SEED = 2, 12, 6, 7
SHARD_TIMED = 60
SHARD_E_RTOL, SHARD_E_ATOL, SHARD_POS_ATOL = 1e-12, 1e-9, 1e-12
# the replica mesh: 4 x trp-cage f32 on the dense sweeps, 20 steps in
# windows of 10; 8 poses scored
REP_MESH_REPLICAS, REP_MESH_STEPS, REP_MESH_EVERY = 4, 20, 10
REP_MESH_POSES = 8
REP_MESH_POS_TOL = 1e-4   # nm, were the blocks not bitwise one batch


def launches_of(counts, kernels=("born_sums", "gb_pair", "descreening",
                                 "take_rows")):
    return {k: counts.get(k, 0) for k in kernels}


def check_launched(counts, kernels, label):
    """Each of kernels launched at least once."""
    for k in kernels:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{label}: {k} not launched")


def phase_native(dev, card):
    """Phase 26: the native f64 engine (runtime/native.py) built with the
    host's make/g++ into the package's _build/: f64 AGBNP1 on the 264-atom
    fixture against the goldens (-2476.66, E_cav 872.514, the displacement
    check 0.0874992 / 0.0886249), then the port's f32 1li2 on the dense
    sweeps (#1-#3, pair_tiles=False) on the card against the native f64
    result (energy and forces within PARITY_TOL).  Returns the launches of
    that evaluation."""
    import numpy as np

    from openmm_agbnp_plugin_tpu_torch import AGBNPParams, load_gaussvol_dat
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.runtime import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("[26] the native engine did not build")
    build_s = time.perf_counter() - t0
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    nat = native.NativeAGBNP1(p)
    out = nat.energy_forces(pos)
    pos2 = np.array(pos)
    pos2[121, 1] += 0.002
    de = nat.energy_forces(pos2)["energy"] - out["energy"]
    pred = out["force"][121][1] * -0.002
    log(f"[26] native engine built/loaded in {build_s:.2f} s "
        f"({native.library_path().parent.name}): fixture E "
        f"{out['energy']:.6f}, E_cav {out['e_cav']:.6f}, displacement dE "
        f"{de:.7f}, gradient prediction {pred:.7f}")
    e_gold, cav_gold, de_gold, pred_gold = NATIVE_GOLDEN
    if not (abs(out["energy"] - e_gold) <= GOLDEN_TOL
            and abs(out["e_cav"] - cav_gold) <= 1e-3
            and abs(de - de_gold) <= NATIVE_DE_TOL
            and abs(pred - pred_gold) <= NATIVE_DE_TOL):
        raise AssertionError("[26] native goldens")

    d, p1 = system("1li2")
    t0 = time.perf_counter()
    ref = native.NativeAGBNP1(p1).energy_forces(d.positions)
    native_s = time.perf_counter() - t0
    m, e, f = sized_model(dev, p1, d.positions, pair_tiles=False)
    PK.reset_launch_counts()
    e, f = m.energy_forces(d.positions)
    counts = PK.launch_counts()
    e_rel = abs(float(e) - ref["energy"]) / abs(ref["energy"])
    fn = f.double().cpu().numpy()
    f_rel = float(np.abs(fn - ref["force"]).max()
                  / np.abs(ref["force"]).max())
    log(f"[26] 1li2 f32 dense sweeps on the card vs the native f64 engine "
        f"({native_s:.2f} s on the host): E {float(e):.4f} / "
        f"{ref['energy']:.4f}, energy rel {e_rel:.3e}, force max-err/max|f| "
        f"{f_rel:.3e}; launches {launches_of(counts)} on {card}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError("[26] 1li2 f32 vs native f64")
    check_launched(counts, ("born_sums", "gb_pair", "descreening",
                            "take_rows"), "[26]")
    return counts


def finite_energies(text, label):
    import re

    # "<x> kJ/mol" and multichip_md's "E[0]=<x> E[-1]=<x> kJ/mol"
    found = [float(a or b) for a, b in re.findall(
        r"(-?\d+\.\d+) kJ/mol|E\[-?\d\]=(-?\d+\.\d+)", text)]
    if not found or not all(math.isfinite(x) and abs(x) < 1e7
                            for x in found):
        raise AssertionError(f"{label}: energies {found}")
    return found


def phase_examples(dev, card):
    """Phase 27: the port's four examples on the card through their main()
    (the scripts' code path, f32): test_agbnp at EXAMPLE_ENV's step counts,
    rescore_conformers (64 poses, 5 reps), remd_trpcage (2 cycles of 40)
    and multichip_md (20 steps over 2 ranks sharing the card, gloo); each
    returns 0 and prints finite energies.  Returns the launches of the
    first three (the ranks' are counted in [28])."""
    import contextlib
    import io

    from openmm_agbnp_plugin_tpu_torch.examples import multichip_md, \
        remd_trpcage, rescore_conformers, test_agbnp
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    saved = {k: os.environ.get(k) for k in EXAMPLE_ENV}
    os.environ.update(EXAMPLE_ENV)
    where = str(dev)
    runs = (("test_agbnp", lambda: test_agbnp.main("trpcage_agbnp1",
                                                   where)),
            ("rescore_conformers",
             lambda: rescore_conformers.main(EXAMPLE_POSES, EXAMPLE_REPS,
                                             where)),
            ("remd_trpcage", lambda: remd_trpcage.main(*EXAMPLE_REMD,
                                                       device=where)),
            ("multichip_md", lambda: multichip_md.main(
                EXAMPLE_MD_STEPS, EXAMPLE_RANKS, where)))
    total = {}
    try:
        for name, run in runs:
            PK.reset_launch_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = run()
            secs = time.perf_counter() - t0
            counts = PK.launch_counts()
            for line in buf.getvalue().splitlines():
                log(f"[27] {name}: {line}")
            found = finite_energies(buf.getvalue(), f"[27] {name}")
            log(f"[27] {name}: rc {rc} in {secs:.1f} s on {card}, "
                f"{len(found)} finite energies, launches "
                f"{pair_launches(counts)}, take_rows {counts['take_rows']}")
            if rc != 0:
                raise AssertionError(f"[27] {name} returned {rc}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return total


def trpcage_sim(dev, dtype, **kw):
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation

    d, _ = system("trpcage")
    return Simulation(d, device=torch.device(dev), version=1, dtype=dtype,
                      **kw)


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed_run(run, pos, vel, steps, gen):
    """ms/step of `steps` more steps continuing (pos, vel) (host clock
    around a synchronised run)."""
    sync(pos.device)
    t0 = time.perf_counter()
    run(pos, vel, steps, generator=gen)
    sync(pos.device)
    return (time.perf_counter() - t0) * 1e3 / steps


def atoms_md(mesh, dev):
    """trp-cage v1 f64 (the dense ops/born.py route; the mesh path's pair
    phases are plain torch too): SHARD_STEPS steps in windows of
    SHARD_EVERY from generator seed SHARD_SEED, then SHARD_TIMED timed
    steps continuing them.  mesh None: the plain runner."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    sim = trpcage_sim(dev, torch.float64, pair_kernel=False)
    run = sim.make_langevin_runner(dt=0.001, neighbor_every=SHARD_EVERY,
                                   mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED)
    PK.reset_launch_counts()
    pos, vel, energies, diag = run(sim.positions, sim.velocities,
                                   SHARD_STEPS, generator=gen)
    sync(dev)
    counts = PK.launch_counts()
    return dict(pos=pos, vel=vel, energies=energies,
                overflow=sim._check_overflow(*diag), counts=counts,
                ms=timed_run(run, pos, vel, SHARD_TIMED, gen))


def rank_atoms_md():
    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import atom_mesh

    mesh = atom_mesh()
    return atoms_md(mesh, mesh.device)


def replica_work(mesh, dev):
    """4 x trp-cage f32 ReplicaEnsemble on the dense sweeps and an 8-pose
    ConformerScorer (NoCutoff: the dense grid) over the replica mesh (or
    mesh None: one process); every output whole, and the launches."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, ConformerScorer, \
        ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    sim = trpcage_sim(dev, torch.float32, pair_tiles=False)
    ens = ReplicaEnsemble(sim, REP_MESH_REPLICAS, mesh=mesh)
    PK.reset_launch_counts()
    states, (energies, *diag) = ens.make_runner(
        neighbor_every=REP_MESH_EVERY)(ens.initial_states(jitter=1e-3),
                                       REP_MESH_STEPS)
    d, p = system("trpcage")
    force = AGBNPForce()
    force.setVersion(1)
    for i in range(p.n):
        force.addParticle(p.radius[i], p.gamma[i], p.alpha[i], p.charge[i],
                          bool(p.ishydrogen[i]))
    poses = jittered(d.positions, REP_MESH_POSES, 28)
    scorer = ConformerScorer(force, d.positions, device=dev, mesh=mesh)
    score = scorer.score(poses, forces=True)
    sync(dev)
    pos = states[0] if mesh is None else mesh.gather(states[0])
    return dict(energies=energies, pos=pos, counts_max=diag[0],
                overflow=sim._check_overflow(
                    *(None if x is None else torch.amax(x, dim=0)
                      for x in diag)),
                score_e=score["energy"], score_f=score["force"],
                launches=PK.launch_counts(),
                finite=bool(np.isfinite(energies.cpu().numpy()).all()))


def rank_replica_work():
    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import replica_mesh

    mesh = replica_mesh()
    return replica_work(mesh, mesh.device)


def phase_sharding(dev, card):
    """Phase 28: sharding over torch.distributed on the card.  The atoms
    mesh: trp-cage v1 f64 MD over 2 gloo ranks sharing cuda:0 (12 steps in
    windows of 6) against the unsharded runner on the card at the JAX
    test's tolerances, the ranks bitwise equal, the tree's take_rows on
    each row block; then the ms/step of 1 rank, 2 ranks and the plain
    runner over SHARD_TIMED more steps (the decomposition's cost on one
    card, not a scale-out).  The replica mesh: ReplicaEnsemble 4 x trp-cage
    and ConformerScorer 8 poses over 2 ranks against one process, replica
    by replica.  Returns the launches in the ranks."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import \
        choose_backend, run_ranks

    backend = choose_backend(SHARD_RANKS, dev.type)
    plain = atoms_md(None, dev)
    t0 = time.perf_counter()
    ranks = run_ranks(rank_atoms_md, SHARD_RANKS, device=dev.type)
    wall = time.perf_counter() - t0
    one = run_ranks(rank_atoms_md, 1, device=dev.type)[0]
    e_p = plain["energies"].cpu().numpy()
    pos_p = plain["pos"].cpu().numpy()
    r0 = ranks[0]
    same = all(np.array_equal(r[k], r0[k]) for r in ranks[1:]
               for k in ("pos", "vel", "energies"))
    e_err = float(np.max(np.abs(r0["energies"] - e_p)
                         - SHARD_E_RTOL * np.abs(e_p)))
    pos_err = float(np.max(np.abs(r0["pos"] - pos_p)))
    e1_same = np.array_equal(one["energies"], r0["energies"])
    log(f"[28] atoms mesh: {SHARD_RANKS} ranks on {dev} ({backend}), "
        f"trp-cage v1 f64, {SHARD_STEPS} steps in windows of {SHARD_EVERY}:"
        f" vs the unsharded runner on the card max|dE| - rtol|E| "
        f"{e_err:.3e} (atol {SHARD_E_ATOL}), max|dx| {pos_err:.3e} nm "
        f"(atol {SHARD_POS_ATOL}); ranks bitwise equal: {same}; 1-rank "
        f"mesh energies bitwise the 2-rank: {e1_same}; launches in rank 0 "
        f"{launches_of(r0['counts'])}; {wall:.1f} s for the 2-rank call")
    log(f"[28] ms/step over {SHARD_TIMED} steps on {card}: plain runner "
        f"{plain['ms']:.3f}, 1-rank mesh {one['ms']:.3f}, 2-rank mesh "
        f"(ranks sharing the card) {[round(r['ms'], 3) for r in ranks]}: "
        f"2 ranks / 1 rank {max(r['ms'] for r in ranks) / one['ms']:.3f}, "
        f"1 rank / plain {one['ms'] / plain['ms']:.3f}")
    if not (same and e_err <= SHARD_E_ATOL and pos_err <= SHARD_POS_ATOL
            and not r0["overflow"] and not plain["overflow"]):
        raise AssertionError("[28] the atoms mesh differs")
    check_launched(r0["counts"], ("take_rows",), "[28] atoms mesh")

    single = replica_work(None, dev)
    t0 = time.perf_counter()
    reps = run_ranks(rank_replica_work, SHARD_RANKS, device=dev.type)
    wall = time.perf_counter() - t0
    s = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
         for k, v in single.items()}
    bitwise = {k: all(np.array_equal(r[k], s[k]) for r in reps)
               for k in ("energies", "pos", "score_e", "score_f")}
    r0 = reps[0]
    e_rel = float(np.max(np.abs(r0["energies"] - s["energies"])
                         / np.abs(s["energies"])))
    pos_err = float(np.max(np.abs(r0["pos"] - s["pos"])))
    se_rel = float(np.max(np.abs(r0["score_e"] - s["score_e"])
                          / np.abs(s["score_e"])))
    sf_rel = float(np.max(np.abs(r0["score_f"] - s["score_f"]))
                   / np.max(np.abs(s["score_f"])))
    ranks_same = all(np.array_equal(r[k], r0[k]) for r in reps[1:]
                     for k in ("energies", "score_e", "score_f"))
    # the energies are per-replica row sums (over the atoms, over the MM
    # terms: trp-cage's 811 dihedrals x 7 orders): does a row sum on the
    # card give a block of rows the bits it gives them among more rows?
    d, p = system("trpcage")
    g = torch.Generator(device=dev).manual_seed(28)
    half = REP_MESH_REPLICAS // SHARD_RANKS
    sums_same = {}
    for what, width in (("atoms", p.n),
                        ("dihedral terms", np.asarray(d.dihedral_fc).size)):
        x = torch.randn((REP_MESH_REPLICAS, width), generator=g, device=dev)
        sums_same[f"{what} ({width})"] = bool(torch.equal(
            torch.sum(x[:half], dim=1), torch.sum(x, dim=1)[:half]))
    log(f"[28] replica mesh: {SHARD_RANKS} ranks x {REP_MESH_REPLICAS // SHARD_RANKS}"
        f" trp-cage replicas ({REP_MESH_STEPS} steps, windows of "
        f"{REP_MESH_EVERY}) and {REP_MESH_POSES} poses scored, vs one "
        f"process: bitwise {bitwise}; energy rel {e_rel:.3e}, max|dx| "
        f"{pos_err:.3e} nm, score energy rel {se_rel:.3e}, force "
        f"max-err/max|f| {sf_rel:.3e}; ranks equal {ranks_same}; f32 "
        f"row sums of {half} rows bitwise the same rows' of "
        f"{REP_MESH_REPLICAS}: {sums_same}; launches "
        f"in rank 0 {launches_of(r0['launches'])}, one process "
        f"{launches_of(s['launches'])}; {wall:.1f} s for the call")
    if not (ranks_same and r0["finite"] and not r0["overflow"]
            and e_rel <= PARITY_TOL and pos_err <= REP_MESH_POS_TOL
            and se_rel <= BATCH_E_TOL and sf_rel <= BATCH_F_TOL):
        raise AssertionError("[28] the replica mesh differs")
    check_launched(r0["launches"], ("born_sums", "gb_pair", "descreening",
                                    "take_rows"), "[28] replica mesh")
    total = {}
    for c in [r["counts"] for r in ranks] + [r["launches"] for r in reps]:
        for k, v in c.items():
            total[k] = total.get(k, 0) + int(v)
    return total


# [29]: mixed=True (f32 pair math, f64 sums, the plain route) on 1li2
MIXED_POSES = 32          # the DMS pose and 31 jittered (numpy seed)
MIXED_JITTER = 0.02       # nm
MIXED_TOL = 1e-5          # relative energy, BASELINE.json's bar, each pose
MIXED_STEPS = 40          # timed steps a run, after an equal warm-up
MIXED_SCORE_POSES = 16    # ConformerScorer(mixed=True), B = 16 vs B = 1
# [30]: the f64 NumPy oracles on the card host
ORACLE_GOLDEN = dict(v0=872.514, v0_e1=2287.78, v0_e2=-1415.27,
                     v1=-2476.66, v1_de=0.0874992, v1_pred=0.0886249)
ORACLE_DE_TOL = 1e-6      # kJ/mol, the displacement check
ORACLE_F32_TOL = 1e-5     # relative energy, f32 #1-#3 vs the oracle
ORACLE_F32_FTOL = 1e-4    # of max|f|, f32 v1 forces vs the oracle
ORACLE_F64_TOL = 1e-9     # relative energy, f64 plain vs the oracle
# tests/test_agbnp2.py:62-82, the v2 anchors on the fixture's first 40 atoms
V2_ORACLE_TERMS = dict(e_vol1=1296.819385880833, e_vol2=-1148.76359737392,
                       e_ms1=27.57599932202746, e_vdw=-279.30181003341033,
                       gb_pair=1114.5651675110894,
                       gb_self=-1476.1241599496998)
V2_ORACLE_FORCES = {0: (2.7244478045, -22.2829483825, -34.7403199228),
                    17: (-116.3420644047, 8.9736090847, -130.7872966600),
                    39: (12.2302176390, 25.9733147403, -30.5733421377)}


def phase_mixed(dev, card):
    """Phase 29: mixed=True on the card, 1li2.  f32 mixed, f32 on the
    plain route and f64 on the plain route over the DMS pose and
    MIXED_POSES - 1 poses jittered MIXED_JITTER nm, at NoCutoff and at
    [22]'s configuration (1 nm, horizon at the cutoff): each mode's energy
    error and max|df|/max|f| against f64, the mean energy error of mixed
    below plain f32's (a single pose can tie: torch's f32 sums are blocked,
    so the plain error already sits at the terms' own roundoff), every
    error within MIXED_TOL.  Then Langevin MD (rebuild windows) of the
    mixed Simulation, [22]'s f64 plain route and [6]'s f32 dense kernels,
    in turns (mixed, f64, kernels, kernels, f64, mixed; MIXED_STEPS timed
    after as many warm-up steps each); ConformerScorer(mixed=True) on
    MIXED_SCORE_POSES poses, each against its own B = 1 score; the
    refusals.  No pair kernel runs under mixed; take_rows (#8) must.
    Returns the launches of the mixed MD and scoring."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (AGBNPModel, ConformerScorer,
                                               Simulation)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel import sharding as S

    d, p = system("1li2")
    rng = np.random.default_rng(29)
    pos0 = np.asarray(d.positions)
    poses = [pos0] + [pos0 + MIXED_JITTER * rng.standard_normal(pos0.shape)
                      for _ in range(MIXED_POSES - 1)]
    for cut in (None, 1.0):
        kw = dict(cutoff=cut, descreen_horizon="cutoff" if cut else None)
        m64 = AGBNPModel(p, device=dev, dtype=torch.float64,
                         pair_kernel=False, positions=pos0, **kw)
        for _ in range(8):  # capacities that hold every pose
            if not any([m64.check_and_grow(m64.energy_forces(
                    x, with_details=True)[2]["diag"]) for x in poses]):
                break
        else:
            raise AssertionError("[29] capacities did not converge")
        plain = AGBNPModel(p, device=dev, dtype=torch.float32,
                           pair_kernel=False, caps=m64.caps, **kw)
        mixed = AGBNPModel(p, device=dev, dtype=torch.float32, mixed=True,
                           caps=m64.caps, **kw)
        if mixed.pair_pad or not mixed.mixed:
            raise AssertionError("[29] mixed must take the plain route")
        errs = {"plain": [], "mixed": []}
        ferrs = {"plain": [], "mixed": []}
        for x in poses:
            e64, f64, out = m64.energy_forces(x, with_details=True)
            if m64.check_and_grow(out["diag"]):
                raise AssertionError("[29] the f64 capacities overflowed")
            for name, m in (("plain", plain), ("mixed", mixed)):
                e, f, out = m.energy_forces(x, with_details=True)
                if m.check_and_grow(out["diag"]):
                    raise AssertionError(f"[29] {name}: capacities "
                                         "overflowed")
                if e.device.type != dev.type or f.device.type != dev.type \
                        or e.dtype != torch.float32:
                    raise AssertionError(f"[29] {name}: {e.device} "
                                         f"{e.dtype}")
                errs[name].append(abs(float(e) - float(e64))
                                  / abs(float(e64)))
                ferrs[name].append(rel_err(f, f64)[0])
        mean = {k: float(np.mean(v)) for k, v in errs.items()}
        log(f"[29] 1li2 cutoff {cut}: energy error vs f64 on the card, DMS "
            f"pose plain {errs['plain'][0]:.3e} mixed "
            f"{errs['mixed'][0]:.3e}; over {MIXED_POSES} poses mean plain "
            f"{mean['plain']:.3e} mixed {mean['mixed']:.3e}, max plain "
            f"{max(errs['plain']):.3e} mixed {max(errs['mixed']):.3e}; "
            f"max|df|/max|f| max plain {max(ferrs['plain']):.3e} mixed "
            f"{max(ferrs['mixed']):.3e}; mixed closer at "
            f"{sum(a < b for a, b in zip(errs['mixed'], errs['plain']))}, "
            f"tied at "
            f"{sum(a == b for a, b in zip(errs['mixed'], errs['plain']))} "
            f"of {MIXED_POSES}; on {card}")
        if not mean["mixed"] < mean["plain"]:
            raise AssertionError(f"[29] cutoff {cut}: mixed not closer to "
                                 "f64 than plain f32")
        if max(errs["plain"] + errs["mixed"]) > MIXED_TOL:
            raise AssertionError(f"[29] cutoff {cut}: energy error above "
                                 f"{MIXED_TOL}")
        del m64, plain, mixed

    sims = dict(mixed=md_sim(dev, "1li2", mixed=True),
                f64=Simulation(d, device=dev, version=1, cutoff=1.0,
                               dtype=torch.float64, skin=0.25,
                               descreen_horizon="cutoff", pair_kernel=False),
                kernels=md_sim(dev, "1li2", pair_tiles=False))
    if not (sims["mixed"].agbnp.mixed and sims["mixed"].agbnp.pair_pad == 0
            and sims["kernels"].agbnp.pair_pad > 0):
        raise AssertionError("[29] the three routes")
    for t in (sims["mixed"].positions, sims["mixed"].masses,
              *sims["mixed"].agbnp.arrays.values()):
        if isinstance(t, torch.Tensor) and t.device.type != dev.type:
            raise AssertionError("[29] a mixed Simulation tensor off the "
                                 "card")
    ms = {k: [] for k in sims}
    counts = {}
    for name in ("mixed", "f64", "kernels", "kernels", "f64", "mixed"):
        _, c, r = run_md(dev, card, "1li2", MIXED_STEPS, f"[29] {name}",
                         sim=sims[name])
        ms[name].append(r["elapsed_s"] / r["steps_run"] * 1e3)
        if name == "mixed":
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            if pair_launches(c):
                raise AssertionError(f"[29] mixed launched pair kernels "
                                     f"{pair_launches(c)}")
    log(f"[29] 1li2 MD ms/step in turns (mixed, f64, kernels, kernels, "
        f"f64, mixed; {MIXED_STEPS} timed steps after {MIXED_STEPS}, "
        f"rebuilds every {NEIGHBOR_EVERY}): "
        f"{ {k: [round(x, 4) for x in v] for k, v in ms.items()} } on "
        f"{card}")

    force = agbnp_force(p, 1)
    scorer = ConformerScorer(force, pos0, device=dev, mixed=True)
    batch = np.stack(poses[:MIXED_SCORE_POSES])
    PK.reset_launch_counts()
    res = scorer.score(batch, forces=True)
    c = PK.launch_counts()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    worst_e = worst_f = 0.0
    for b in range(MIXED_SCORE_POSES):
        one = scorer.score(batch[b], forces=True)
        e1 = float(one["energy"][0])
        worst_e = max(worst_e, abs(float(res["energy"][b]) - e1) / abs(e1))
        worst_f = max(worst_f, rel_err(res["force"][b], one["force"][0])[0])
    log(f"[29] ConformerScorer(mixed=True), {MIXED_SCORE_POSES} poses: "
        f"B = {MIXED_SCORE_POSES} vs each pose's B = 1 score: energy rel "
        f"{worst_e:.3e}, force max-err/max|f| {worst_f:.3e}; launches "
        f"{ {k: v for k, v in c.items() if v} }")
    if not (worst_e <= BATCH_E_TOL and worst_f <= BATCH_F_TOL) \
            or res["energy"].device.type != dev.type:
        raise AssertionError("[29] mixed scorer batch vs each pose")
    if pair_launches(c):
        raise AssertionError("[29] the mixed scorer launched pair kernels")

    refused = 0
    mesh = S.Mesh(group=None, rank=0, size=2, device=dev, axis="atoms")
    for what, fn in (
            ("pair_kernel=True", lambda: AGBNPModel(
                p, device=dev, dtype=torch.float32, pair_kernel=True,
                mixed=True)),
            ("version 2", lambda: Simulation(d, device=dev, version=2,
                                             dtype=torch.float32,
                                             mixed=True)),
            ("atoms mesh", lambda: sims["mixed"].make_langevin_runner(
                mesh=mesh))):
        try:
            fn()
        except ValueError as exc:
            refused += 1
            log(f"[29] refused, {what}: {exc}")
    if refused != 3:
        raise AssertionError("[29] a mixed refusal did not fire")
    if counts.get("take_rows", 0) < 1:
        raise AssertionError("[29] take_rows not launched on the mixed "
                             "path")
    log(f"[29] launches on the mixed path (MD and scoring): "
        f"{ {k: v for k, v in counts.items() if v} }")
    torch.cuda.synchronize()
    return counts


def phase_oracle(dev, card):
    """Phase 30: the port's f64 NumPy oracles (models/oracle.py,
    models/oracle_agbnp2.py; no JAX on this host) as the golden.  Their
    own goldens first: GVolSA 872.514 (2287.78 / -1415.27), AGBNP1
    -2476.66 and the displacement check 0.0874992 / 0.0886249, the v2
    anchors on the fixture's first 40 atoms.  Then the card against them on
    all 264 atoms: f32 v1 and v2 through #1-#3 (the dense grid at
    NoCutoff; energy ORACLE_F32_TOL, v1 forces ORACLE_F32_FTOL of max|f|),
    f64 v1 and v2 on the plain route (energy ORACLE_F64_TOL).  v2 forces
    are not compared: the oracle's v2 force chain is the reference's
    knowingly incomplete hand chain.  Returns the launches of the card's
    evaluations."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import (AGBNP2Model, AGBNPModel,
                                               AGBNPParams,
                                               load_gaussvol_dat)
    from openmm_agbnp_plugin_tpu_torch.models import oracle as O
    from openmm_agbnp_plugin_tpu_torch.models import oracle_agbnp2 as O2
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    n = V2_GOLDEN_ATOMS
    p40 = AGBNPParams(radius=radius[:n], gamma=gamma[:n], alpha=alpha[:n],
                      charge=charge[:n], ishydrogen=ish[:n])
    host = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        host[name] = round(time.perf_counter() - t0, 3)
        return out

    e0, _, (e1, e2) = timed("v0", O.gvolsa_energy_forces, p, pos)
    ev1, fv1 = timed("v1", O.agbnp1_energy_forces, p, pos)
    pos2 = np.array(pos)
    pos2[121, 1] += 0.002
    ev1b, _ = timed("v1_displaced", O.agbnp1_energy_forces, p, pos2)
    de, pred = ev1b - ev1, -fv1[121, 1] * 0.002
    e40, f40, det40 = timed("v2_40", O2.agbnp2_energy_forces, p40, pos[:n],
                            return_details=True)
    ev2 = timed("v2_264", O2.agbnp2_energy_forces, p, pos)[0]
    g = ORACLE_GOLDEN
    log(f"[30] the port's oracle on the host (s {host}): v0 {e0:.6f} "
        f"({e1:.4f} / {e2:.4f}), v1 {ev1:.6f}, displacement dE {de:.7f} "
        f"prediction {pred:.7f}, v2 40 atoms {e40:.10f}, v2 264 atoms "
        f"{ev2:.10f}")
    if not (abs(e0 - g["v0"]) <= 1e-3 and abs(e1 - g["v0_e1"]) <= 0.01
            and abs(e2 - g["v0_e2"]) <= 0.01
            and abs(ev1 - g["v1"]) <= GOLDEN_TOL
            and abs(de - g["v1_de"]) <= ORACLE_DE_TOL
            and abs(pred - g["v1_pred"]) <= ORACLE_DE_TOL):
        raise AssertionError("[30] the oracle's v0/v1 goldens")
    if not (abs(e40 - V2_GOLDEN_E) <= 1e-10 * abs(V2_GOLDEN_E)
            and det40["num_ms"] == 28
            and all(abs(det40[k] - v) <= 1e-9 * abs(v)
                    for k, v in V2_ORACLE_TERMS.items())
            and all(np.allclose(f40[i], v, rtol=1e-8, atol=0)
                    for i, v in V2_ORACLE_FORCES.items())):
        raise AssertionError("[30] the oracle's v2 anchors")

    counts = {}
    rows = []

    def card_eval(label, m, want, ftol=None, f_want=None):
        PK.reset_launch_counts()
        for _ in range(8):
            e, f, out = m.energy_forces(pos, with_details=True)
            diag = out["diags"] if "diags" in out else out["diag"]
            if not m.check_and_grow(diag):
                break
        else:
            raise AssertionError(f"[30] {label}: capacities")
        c = PK.launch_counts()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        e_rel = abs(float(e) - want) / abs(want)
        f_rel = (float(np.abs(f.double().cpu().numpy() - f_want).max()
                       / np.abs(f_want).max()) if f_want is not None
                 else None)
        rows.append((label, float(e), e_rel, f_rel,
                     {k: v for k, v in c.items() if v}))
        return e_rel, f_rel, c

    dense = ("born_sums", "gb_pair", "descreening")
    e_rel, f_rel, c = card_eval(
        "v1 f32 #1-#3", AGBNPModel(p, device=dev, dtype=torch.float32,
                                   positions=pos, pair_tiles=False),
        ev1, f_want=fv1)
    if not (e_rel <= ORACLE_F32_TOL and f_rel <= ORACLE_F32_FTOL):
        raise AssertionError("[30] v1 f32 vs the oracle")
    check_launched(c, dense + ("take_rows",), "[30] v1 f32")
    e_rel, _, c = card_eval(
        "v2 f32 #1-#3", AGBNP2Model(p, device=dev, dtype=torch.float32,
                                    positions=pos), ev2)
    if not e_rel <= ORACLE_F32_TOL:
        raise AssertionError("[30] v2 f32 vs the oracle")
    check_launched(c, dense + ("take_rows",), "[30] v2 f32")
    e_rel, _, _ = card_eval(
        "v1 f64 plain", AGBNPModel(p, device=dev, dtype=torch.float64,
                                   pair_kernel=False), ev1, f_want=fv1)
    if not e_rel <= ORACLE_F64_TOL:
        raise AssertionError("[30] v1 f64 vs the oracle")
    e_rel, _, _ = card_eval(
        "v2 f64 plain", AGBNP2Model(p, device=dev, dtype=torch.float64,
                                    positions=pos, pair_kernel=False), ev2)
    if not e_rel <= ORACLE_F64_TOL:
        raise AssertionError("[30] v2 f64 vs the oracle")
    for label, e, e_rel, f_rel, c in rows:
        log(f"[30] card {label}: E {e:.10f}, energy rel {e_rel:.3e}"
            + ("" if f_rel is None else f", force max-err/max|f| "
               f"{f_rel:.3e}") + f"; launches {c} on {card}")
    torch.cuda.synchronize()
    return counts


# [31]: large N, the JAX package's large-system path: ops/tree.py's chunked
# sibling build (one-shot against chunked, bitwise), synthetic.run_md at
# 16,384 atoms and synthetic.run at 24,576 (benchmarks/synthetic_scale.py)
# (a) one-shot and chunked, bitwise: the shipped proteins, then the ball
LARGE_BUILDS = ("1li2", "2clr", 10240, 16384)
LARGE_MD_ATOMS = 16384              # (b) run_md
LARGE_MD_STEPS = 120                # (b) run_md's nsteps: 4 heat and 2
#                                     timed windows of SYNTH_EVERY steps
LARGE_EVAL_ATOMS = 24576            # (c) run, the native engine, the kernels
LARGE_EVAL_REPEATS = 5              # (c) timed evaluations
# (a) the one-shot build at 24,576 atoms is tried when its peak, predicted
# from the 16,384-atom build's bytes a candidate, is below this share of
# the card's free memory
ONESHOT_FREE_SHARE = 0.7
BUILD_TIMES = 5             # (a) builds a mode timed with CUDA events
# list entries a twin takes at once at the 24,576-atom shapes (each entry
# is a T x T block of every temporary)
TWIN_ENTRIES = 256
DISPATCH = ("_CHUNK_BUILD_ELEMS", "_CHUNK_LEVEL_MIN", "_SLICE_BUILD_TOTAL")


@contextlib.contextmanager
def tree_dispatch(chunked: bool):
    """Every sibling level built in row blocks (chunked) or in one shot,
    whatever the shipped thresholds say, for the block's duration."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    old = {k: getattr(T, k) for k in DISPATCH}
    for k in DISPATCH:
        setattr(T, k, 0 if chunked else 1 << 62)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(T, k, v)


@contextlib.contextmanager
def qd_limit(nbytes: int):
    """The model's Q/dQ limit set to nbytes for the block's duration."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M

    old = M.QD_BYTES_LIMIT
    M.QD_BYTES_LIMIT = nbytes
    try:
        yield
    finally:
        M.QD_BYTES_LIMIT = old


def ball_params(natoms):
    from openmm_agbnp_plugin_tpu_torch import AGBNPParams
    from openmm_agbnp_plugin_tpu_torch.utils.synthetic import synthetic_system

    pos, radius, gamma, alpha, charge, ish = synthetic_system(natoms)
    return pos, AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                            charge=charge, ishydrogen=ish)


def level_candidates(caps):
    """The window candidates of each sibling level, cap_prev x offs."""
    return [c * o for c, o in zip(caps.caps[:-1], caps.offs)]


def tree_builds(dev, m, pos, label, modes):
    """The model's overlap tree at the large radii built at pos under each
    of modes (True: chunked, False: one-shot), each twice: the levels and
    diag of the first build and the peak device memory above what was
    allocated before either (bytes); then BUILD_TIMES more builds of each
    mode, one after the other without emptying the cache, timed with CUDA
    events: their median ms.  Every pair of builds is bitwise equal."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    a = m.arrays
    pt = torch.as_tensor(pos, dtype=m.dtype, device=dev)
    ap, pair_rows, _ = M.tree_candidates(a, pt, m.neighbor_rcut,
                                         m.neighbor_kmax, m.neighbor_grid)
    lvl1 = T.make_level1(pt, a["radii_large"], a["vol_large"],
                         a["gamma"] / m.params.roffset, a["ishydrogen"])
    def build():
        return T.build_tree(lvl1, ap["pairs_i"], ap["pairs_j"], m.caps,
                            pairs_valid=ap["pairs_valid"],
                            pair_rows=pair_rows)

    out = {}
    for chunked in modes:
        runs = []
        for _ in range(2):
            with tree_dispatch(chunked):
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                levels, diag = build()
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) - base
            runs.append((levels, diag, peak))
        same_tree(f"{label} {'chunked' if chunked else 'one-shot'}, twice",
                  runs[0][:2], runs[1][:2])
        if T.check_overflow({k: v[0] for k, v in diag.items()})["any"]:
            raise AssertionError(f"[31] {label}: the build overflowed")
        times = []
        with tree_dispatch(chunked):
            for _ in range(BUILD_TIMES):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                build()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        out[chunked] = (runs[0][0], runs[0][1], sorted(times)[len(times) // 2],
                        max(runs[0][2], runs[1][2]))
        del runs
    if len(modes) == 2:
        same_tree(f"{label} chunked vs one-shot", out[True][:2],
                  out[False][:2])
    return {k: v[2:] for k, v in out.items()}


def same_tree(label, a, b):
    """Two builds' levels and diags bitwise equal: _ints, _dat, valid and
    every bnd leaf of every level, and every diag leaf."""
    import torch

    (la, da), (lb, db) = a, b
    for k in da:
        if not torch.equal(da[k], db[k]):
            raise AssertionError(f"[31] {label}: diag {k} differs")
    for n, (x, y) in enumerate(zip(la, lb)):
        for k in ("_ints", "_dat", "valid"):
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"[31] {label}: level {n + 2} {k} "
                                     "differs")
        for k in x["bnd"]:
            if not torch.equal(x["bnd"][k], y["bnd"][k]):
                raise AssertionError(f"[31] {label}: level {n + 2} bnd {k} "
                                     "differs")


# the arguments of each list kernel that carry the replica axis (the
# model evaluates one system as a batch of one)
REPLICA_ARGS = dict(born_sums_tiles=(0, 1, 2, 3, 9),
                    gb_pair_tiles=(0, 1, 2, 4),
                    descreening_tiles=(0, 1, 2, 3, 4, 5, 6, 7))


def unlead_args(name, args):
    """A batch-of-one call's arguments as one system's: the replica axis
    taken off the arguments that carry it."""
    def one(x):
        if isinstance(x, tuple):
            return tuple(one(t) for t in x)
        if x is None:
            return None
        if x.shape[0] != 1:
            raise AssertionError(f"[31] {name}: a batch of {x.shape[0]}")
        return x[0]

    lead = REPLICA_ARGS.get(name, ())
    return tuple(one(a) if k in lead else a for k, a in enumerate(args))


@contextlib.contextmanager
def recorded_calls(calls):
    """The arguments of the list kernels' and take_rows' calls made inside
    the block, kept in calls[name] as one system's (the list kernels'
    first call; the take_rows call that moves the most bytes)."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    def recorder(mod, name, key=None):
        orig = getattr(mod, name)

        def call(*args, **kw):
            k = key(args) if key else 0
            if name not in calls or k > calls[name][2]:
                calls[name] = (unlead_args(name, args), kw, k)
            return orig(*args, **kw)
        return mod, name, orig, call

    def moved(args):
        tab, ids = args
        return ids.shape[0] * (tab[0].numel() + 1)

    hooks = [recorder(TL, "born_sums_tiles"), recorder(TL, "gb_pair_tiles"),
             recorder(TL, "descreening_tiles"),
             recorder(T, "take_rows", key=moved)]
    for mod, name, _, call in hooks:
        setattr(mod, name, call)
    try:
        yield calls
    finally:
        for mod, name, orig, _ in hooks:
            setattr(mod, name, orig)


def twin_in_parts(twin, nv, tl, *args, **kw):
    """A list twin over its list TWIN_ENTRIES entries at a time: the row
    and column sums of every part added, the per-entry Q/dQ the Born twin
    returns joined, those the reload takes cut with their entries."""
    import torch

    lmax = tl.shape[1]

    def entries(a, lo, hi):
        # per-entry Q/dQ ([lmax, T, T] each) go with their entries
        if isinstance(a, tuple) and all(
                isinstance(t, torch.Tensor) and t.dim() == 3
                and t.shape[0] == lmax for t in a):
            return tuple(t[lo:hi] for t in a)
        return a

    outs = []
    for lo in range(0, lmax, TWIN_ENTRIES):
        hi = min(lo + TWIN_ENTRIES, lmax)
        part = twin(torch.clamp(nv - lo, 0, hi - lo), tl[:, lo:hi],
                    *(entries(a, lo, hi) for a in args), **kw)
        outs.append(part if isinstance(part, tuple) else (part,))
    joined = []
    for k, first in enumerate(outs[0]):
        if first is None:
            joined.append(None)
        elif first.dim() == 3:
            joined.append(torch.cat([o[k] for o in outs]))
        else:
            joined.append(sum(o[k] for o in outs))
    return tuple(joined) if len(joined) > 1 else joined[0]


def large_kernels(calls, label):
    """#5-#8 as the 24,576-atom evaluation launched them: each kernel
    again on its recorded inputs, held against its twin (the list twins
    in parts of TWIN_ENTRIES entries), and timed beside the twin and its
    bound, as [2] times them; descreening both reloading the Born
    kernel's Q/dQ and recomputing the spline.  Returns {name: record}."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    out = {}

    def check(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for k, (o, r) in enumerate(zip(got, want)):
            if r is None:
                continue
            rel, diff = rel_err(o, r)
            log(f"    {name:27s} {label} out{k}: max|d|/max|ref| = "
                f"{rel:.3e}")
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"[31] {name} {label} output {k}: "
                                     f"{rel:.3e} > {KERNEL_TOL}")
            worst = max(worst, diff)
        return worst

    def record(name, kern, plain, err, live, ops, moved, **info):
        b_ms, b_by = bound_ms(live, OPS_PER_PAIR[ops], moved)
        rec = dict(ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain, 3),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   max_abs_err=err, live_pairs=live, bytes=moved, **info)
        out[name] = rec
        log(f"    {label} {name:27s} kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {live} "
            f"live pairs, {moved} bytes; {info})")

    b_args, b_kw, _ = calls["born_sums_tiles"]
    nv, tl, pos_pad, pos_h = b_args[:4]
    n, tile = b_args[10], b_args[11]
    horizon = b_kw.get("horizon")
    spline = PK.SplineArgs(*b_args[4:9], n, horizon)
    live_b = count_live(pos_pad, pos_h, n, spline, "born", horizon)
    path_qd = bool(b_kw.get("save_qd", False))
    kw_qd = dict(b_kw, save_qd=True)
    got = TL.born_sums_tiles(*b_args, **kw_qd)
    want = twin_in_parts(TL.born_sums_tiles_reference, *b_args, **kw_qd)
    err = check("born_sums_tiles", got[0], want[0])
    record("born_sums_tiles", lambda: TL.born_sums_tiles(*b_args, **b_kw),
           lambda: twin_in_parts(TL.born_sums_tiles_reference, *b_args,
                                 **b_kw),
           err, live_b, "born", nbytes(b_args, got[0])
           + (nbytes(got[3:]) + 8 * live_b if path_qd else 0),
           list=f"nv {int(nv[0])}/lmax {tl.shape[1]}", save_qd=path_qd)
    qd_k, qd_t = got[1:], want[1:]
    del got, want

    g_args, g_kw, _ = calls["gb_pair_tiles"]
    got = TL.gb_pair_tiles(*g_args, **g_kw)
    err = check("gb_pair_tiles", got,
                twin_in_parts(TL.gb_pair_tiles_reference, *g_args, **g_kw))
    live_g = count_live(g_args[2], g_args[2], g_args[5], None, "gb",
                        g_kw["cutoff"])
    record("gb_pair_tiles", lambda: TL.gb_pair_tiles(*g_args, **g_kw),
           lambda: twin_in_parts(TL.gb_pair_tiles_reference, *g_args,
                                 **g_kw),
           err, live_g, "gb_mm" if g_kw.get("sig_pad") is not None
           else "gb", nbytes(g_args, g_kw, got),
           list=f"nv {int(g_args[0][0])}/lmax {g_args[1].shape[1]}")
    del got

    d_args, d_kw, _ = calls["descreening_tiles"]
    d_in = d_args[:7]
    for name, qd, tw_qd, spl, ops, extra in (
            ("descreening_tiles", qd_k, qd_t, spline, "descreen",
             8 * live_b),
            ("descreening_tiles_recompute", None, None, spline,
             "descreen_spline", 0)):
        dkw = dict(d_kw, spline=spl)
        got = TL.descreening_tiles(*d_in, qd, tile, **dkw)
        err = check(name, got, twin_in_parts(
            TL.descreening_tiles_reference, *d_in, tw_qd, tile, **dkw))
        record(name, lambda: TL.descreening_tiles(*d_in, qd, tile, **dkw),
               lambda: twin_in_parts(TL.descreening_tiles_reference, *d_in,
                                     tw_qd, tile, **dkw),
               err, live_b, ops,
               nbytes(d_in, got, qd[2:] if qd else None) + extra,
               on_the_path=(d_args[7] is None) == (qd is None))
        del got
    del qd_k, qd_t

    t_args, _, _ = calls["take_rows"]
    tab, iv = t_args
    got = RW.take_rows(tab, iv)
    if not torch.equal(got, RW.take_rows_reference(tab, iv)):
        raise AssertionError(f"[31] take_rows {label}: differs from the twin")
    rec = take_timed(tab, iv)
    cols = 1 if tab.dim() == 1 else tab.shape[1]
    rec.update(max_abs_err=0.0, library="torch.index_select",
               shape=f"{iv.shape[0]} rows x {cols} from {tab.shape[0]}")
    out["take_rows"] = rec
    log(f"    {label} take_rows {rec['shape']}: bitwise the twin; kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"torch.index_select {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['bytes']} bytes)")
    return out


def phase_large(dev, card):
    """Phase 31: large N.  (a) The overlap tree of each of LARGE_BUILDS
    (AGBNPModel f32, cutoff 1 nm, sized from the positions) built one-shot
    and chunked: levels bitwise equal, ms and peak memory of each, the
    chunked peak below the one-shot's.  (b) synthetic.run_md at
    16,384 atoms (20-step windows, tile lists, the cell grid; the windowed
    protocol, LARGE_MD_STEPS: 4 heat and 2 timed windows): no overflow
    left, finite energies, #5-#7 every step run (#7 recomputing where the
    lists' Q/dQ are not shared), the tree kernels at every level.
    (c) synthetic.run at 24,576 atoms (LARGE_EVAL_REPEATS timed
    evaluations): whether its lists share Q/dQ (lb T^2 8 against
    QD_BYTES_LIMIT), one evaluation with share_qd=False against one with
    the lists' Q/dQ shared (the limit raised to their bytes for it) and the
    model's own (1e-5), the f32 evaluation against the native f64 engine on
    the card's host (energy PARITY_TOL, forces SYNTH_F_TOL of max|f|), its
    tree built chunked (and one-shot when it fits), and #5-#8 timed at its
    shapes.  Returns (launches of (b) and (c), the kernel records of
    (c))."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.runtime import native
    from openmm_agbnp_plugin_tpu_torch.utils import synthetic

    torch.cuda.empty_cache()
    gb = 1024 ** 3
    log(f"[31] large N on {card}; dispatch thresholds "
        f"{ {k: getattr(T, k) for k in DISPATCH + ('_CHUNK_ROWS',)} }")
    per_cand = None
    for what in LARGE_BUILDS:
        if isinstance(what, str):
            d, p = system(what)
            pos = d.positions
        else:
            pos, p = ball_params(what)
        label = f"{what} ({p.n} atoms)" if isinstance(what, str) else \
            f"{what} atoms"
        t0 = time.perf_counter()
        m = AGBNPModel(p, device=dev, dtype=torch.float32, version=1,
                       cutoff=1.0, positions=pos)
        init_s = time.perf_counter() - t0
        cands = level_candidates(m.caps)
        b = tree_builds(dev, m, pos, label, (False, True))
        (ms1, peak1), (msc, peakc) = b[False], b[True]
        per_cand = peak1 / max(cands)
        pressured = sum(cands) > T._SLICE_BUILD_TOTAL
        log(f"[31] (a) {label}: model sized in {init_s:.1f} s, caps "
            f"{m.caps.caps}, offs {m.caps.offs}; window candidates "
            f"{cands} (total {sum(cands)}; the shipped dispatch chunks "
            f"{[c for c in cands if pressured and c > T._CHUNK_LEVEL_MIN]}"
            f"); one-shot {ms1:.1f} ms, peak {peak1 / gb:.3f} GiB "
            f"({per_cand:.1f} bytes a candidate of its largest level); "
            f"chunked {msc:.1f} ms, peak {peakc / gb:.3f} GiB; levels and "
            "diag bitwise equal")
        if not peakc < peak1:
            raise AssertionError(f"[31] {label}: the chunked peak is not "
                                 "below the one-shot peak")
        del m
    torch.cuda.empty_cache()

    PK.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    r = synthetic.run_md(LARGE_MD_ATOMS, nsteps=LARGE_MD_STEPS, device=dev,
                         neighbor_every=SYNTH_EVERY)
    md_counts = PK.launch_counts()
    sim = r["sim"]
    lb = sim.agbnp.pair_tiles[0] if sim.agbnp.pair_tiles else 0
    tile = PK.pick_tile(LARGE_MD_ATOMS)
    md_shared = lb * tile * tile * 8 <= M.QD_BYTES_LIMIT
    log(f"[31] (b) Q/dQ {lb * tile * tile * 8} bytes, shared {md_shared}; "
        f"peak {torch.cuda.max_memory_allocated(dev) / gb:.3f} GiB")
    check_windowed_md(r, md_counts, card, "[31] (b)", qd_shared=md_shared)
    del r, sim
    torch.cuda.empty_cache()

    PK.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    r = synthetic.run(LARGE_EVAL_ATOMS, repeats=LARGE_EVAL_REPEATS,
                      device=dev)
    eval_counts = PK.launch_counts()
    m = r["model"]
    pos, p = ball_params(LARGE_EVAL_ATOMS)
    lb = m.pair_tiles[0]
    tile = PK.pick_tile(LARGE_EVAL_ATOMS)
    qd_bytes = lb * tile * tile * 8
    shared = qd_bytes <= M.QD_BYTES_LIMIT
    log(f"[31] (c) run({LARGE_EVAL_ATOMS}), f32, 1 nm: "
        f"{r['s_per_eval'] * 1e3:.2f} ms an evaluation on {card} (the JAX "
        f"package's TPU figure 10.1 s is the TPU's); set-up "
        f"{r['init_s']:.1f} s, first evaluations {r['first_s']:.1f} s, "
        f"regrows {r['regrows']}, overflow {r['overflow']}; grid "
        f"{r['grid']}, kmax {r['kmax']}, caps {r['caps']}, offs {r['offs']}, "
        f"pair_tiles {r['pair_tiles']}; Q/dQ lb T^2 8 = {qd_bytes} bytes "
        f"against QD_BYTES_LIMIT {M.QD_BYTES_LIMIT}: "
        f"{'shared' if shared else 'recomputed'}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / gb:.3f} GiB; launches "
        f"{pair_launches(eval_counts)}, take_rows {eval_counts['take_rows']}")
    if r["overflow"] or not r["grid"] or m.pair_tiles is None:
        raise AssertionError("[31] (c) overflow left, or no cell grid, lists")
    check_list_launches(eval_counts, LARGE_EVAL_REPEATS, "[31] (c)",
                        qd_shared=shared)
    calls = {}
    with recorded_calls(calls):
        e_on, f_on = m.energy_forces(pos)
    # share_qd off (#7 recomputing) against the lists' Q/dQ shared (#7
    # reloading them), with the limit raised for that one evaluation where
    # the lists' Q/dQ are over it
    PK.reset_launch_counts()
    with qd_limit(max(qd_bytes, M.QD_BYTES_LIMIT)):
        e_re, f_re = m.energy_forces(pos)
    re_counts = PK.launch_counts()
    m.share_qd = False
    PK.reset_launch_counts()
    e_off, f_off = m.energy_forces(pos)
    off_counts = PK.launch_counts()
    m.share_qd = True
    e_rel = abs(float(e_off) - float(e_re)) / abs(float(e_re))
    f_rel = rel_err(f_off, f_re)[0]
    on_rel = abs(float(e_on) - float(e_re)) / abs(float(e_re))
    on_f_rel = rel_err(f_on, f_re)[0]
    log(f"[31] (c) share_qd=False vs Q/dQ shared ({qd_bytes} bytes, the "
        f"limit raised to it for this evaluation): energy rel {e_rel:.3e}, "
        f"force max-err/max|f| {f_rel:.3e}; the model's own "
        f"({'shared' if shared else 'recomputed'}) evaluation vs shared: "
        f"energy rel {on_rel:.3e}, force {on_f_rel:.3e}; launches shared "
        f"{pair_launches(re_counts)}, off {pair_launches(off_counts)}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL
            and on_rel <= PARITY_TOL and on_f_rel <= PARITY_TOL):
        raise AssertionError("[31] (c) share_qd off vs on")
    if re_counts["descreening_tiles"] < 1:
        raise AssertionError("[31] (c) the shared evaluation did not reload")
    if off_counts["descreening_tiles_recompute"] < 1:
        raise AssertionError("[31] (c) share_qd=False did not recompute")
    del f_re, f_off
    eval_counts = {k: c + re_counts[k] + off_counts[k]
                   for k, c in eval_counts.items()}

    t0 = time.perf_counter()
    ref = native.NativeAGBNP1(p).energy_forces(pos, cutoff=1.0)
    native_s = time.perf_counter() - t0
    e_rel = abs(float(e_on) - ref["energy"]) / abs(ref["energy"])
    fn = f_on.double().cpu().numpy()
    f_rel = float(np.abs(fn - ref["force"]).max()
                  / np.abs(ref["force"]).max())
    log(f"[31] (c) f32 on the card vs the native f64 engine on its host "
        f"({native_s:.1f} s): E {float(e_on):.4f} / {ref['energy']:.4f}, "
        f"energy rel {e_rel:.3e}, force max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= PARITY_TOL and f_rel <= SYNTH_F_TOL):
        raise AssertionError("[31] (c) f32 vs the native f64 engine")
    del ref, f_on

    cands = level_candidates(m.caps)
    free = torch.cuda.mem_get_info(dev)[0]
    predicted = per_cand * max(cands)
    fits = predicted < ONESHOT_FREE_SHARE * free
    b = tree_builds(dev, m, pos, f"{LARGE_EVAL_ATOMS} atoms",
                    (True, False) if fits else (True,))
    msc, peakc = b[True]
    log(f"[31] (a) {LARGE_EVAL_ATOMS} atoms: window candidates {cands} "
        f"(total {sum(cands)}); chunked {msc:.1f} ms, peak "
        f"{peakc / gb:.3f} GiB; one-shot predicted peak "
        f"{predicted / gb:.2f} GiB against {free / gb:.2f} GiB free: "
        + (f"built in {b[False][0]:.1f} ms, peak {b[False][1] / gb:.3f} "
           "GiB, bitwise the chunked build" if fits else "not tried"))
    if fits and not peakc < b[False][1]:
        raise AssertionError(f"[31] {LARGE_EVAL_ATOMS} atoms: the chunked "
                             "peak is not below the one-shot peak")

    log(f"[31] (c) #5-#8 at the {LARGE_EVAL_ATOMS}-atom evaluation's shapes "
        "(CUDA events behind a device sleep; twins in parts of "
        f"{TWIN_ENTRIES} list entries)")
    records = large_kernels(calls, f"{LARGE_EVAL_ATOMS // 1024}k")
    del calls, m, r
    torch.cuda.empty_cache()
    return dict(md_16k=md_counts, eval_24k=eval_counts), records


# [32]: reduce_tree's free volumes (GaussVol's compute_volume outputs)
FREEVOL_TOL = 1e-5        # of max|free_volume|, and relative in the volume


def phase_freevol(dev, card):
    """Phase 32: reduce_tree(with_freevol=True) in f32 on the card on the
    large-radii overlap tree of 1li2 as AGBNPModel builds it (sized from
    the positions), over the fixed-topology rescan of its volumes (the MD
    window's pass), against the native f64 engine (runtime/native.py,
    NativeGaussVol.compute_volume) on the host: free volumes within
    FREEVOL_TOL of their max, the total volume FREEVOL_TOL relative;
    rescan and reduction twice bitwise; take_rows at every level of each
    rescan (the reduction itself sums segments and moves no rows).
    Returns the launches of the two rescans and reductions."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.models.constants import sphere_volume
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.runtime import native

    d, p = system("1li2")
    m = AGBNPModel(p, device=dev, dtype=torch.float32, positions=d.positions)
    pos = torch.as_tensor(d.positions, dtype=torch.float32, device=dev)
    a, pair_rows, _ = M.tree_candidates(m.arrays, pos, m.neighbor_rcut,
                                        m.neighbor_kmax, m.neighbor_grid)
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                         a["gamma"] / p.roffset, a["ishydrogen"])
    levels, diag = T.build_tree(lvl1, a["pairs_i"], a["pairs_j"], m.caps,
                                pairs_valid=a["pairs_valid"],
                                pair_rows=pair_rows)
    if T.check_overflow({k: v[0] for k, v in diag.items()})["any"]:
        raise AssertionError("[32] the tree overflowed its capacities")
    topo = T.tree_topology(levels)
    PK.reset_launch_counts()
    t0 = time.perf_counter()
    red = T.reduce_tree(T.rescan_volumes(topo, lvl1), lvl1, with_freevol=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    again = T.reduce_tree(T.rescan_volumes(topo, lvl1), lvl1,
                          with_freevol=True)
    counts = PK.launch_counts()
    gathers = GATHERS_PER_LEVEL * T.NUM_TREE_LEVELS * 2
    if counts["take_rows"] < gathers:
        raise AssertionError(f"[32] take_rows {counts['take_rows']} < "
                             f"{gathers}")
    for k in ("free_volume", "volume", "self_volume", "energy", "dr"):
        if not torch.equal(red[k], again[k]):
            raise AssertionError(f"[32] {k} differs between two reductions")

    radii = np.asarray(p.radii_large, np.float64)
    volumes = np.where(np.asarray(p.ishydrogen) > 0, 0.0,
                       sphere_volume(radii))
    t0 = time.perf_counter()
    ng = native.NativeGaussVol(p.n, p.ishydrogen)
    ng.compute_tree(d.positions, radii, volumes,
                    np.asarray(p.gamma) / p.roffset)
    _, volume, _, _, fv, _ = ng.compute_volume()
    native_s = time.perf_counter() - t0
    got = red["free_volume"].double().cpu().numpy()
    fv_err = float(np.abs(got - fv).max() / np.abs(fv).max())
    v_err = abs(float(red["volume"][0]) - volume) / abs(volume)
    log(f"[32] 1li2 free volumes, f32 reduce_tree(with_freevol=True) on "
        f"{card} ({ms:.2f} ms, the first call) vs the native f64 engine "
        f"({native_s:.2f} s on the host): volume {float(red['volume'][0]):.6f}"
        f" / {volume:.6f} nm^3, relative {v_err:.3e}; free volumes "
        f"max-err/max {fv_err:.3e} (sum {got.sum():.6f} / {fv.sum():.6f}); "
        f"tree rows {m.caps.caps}; take_rows {counts['take_rows']}")
    if not (fv_err <= FREEVOL_TOL and v_err <= FREEVOL_TOL):
        raise AssertionError("[32] free volumes f32 vs the native engine")
    return counts


# [33]: the fixed-topology tree passes as per-level kernels (csrc/tree.cu)
TREE_KERNELS = ("tree_rescan", "tree_reduce", "tree_deposit")
# each kernel's wrapper in ops/kernels/tree.py, one launch a call
TREE_WRAPPERS = dict(tree_rescan="rescan_level", tree_reduce="reduce_level",
                     tree_deposit="deposit_atoms")
# (system, replicas) of each fixed topology: the MD cells' three
TREE_CASES = (("1li2", 1), ("2clr", 1), ("2clr", 4))
TREE_REPEATS = 40       # pass repetitions a timing
TREE_MD_STEPS = 80      # MD steps a turn (two rebuild windows)
TREE_TURNS = 2          # turns of the route and the torch twin in MD
# f32 against the f64 twin, of max|x| (energies relative): the f32 path's
# 1e-5, and for the cavity force 3e-5, about twice what the f32 twin itself
# reads at 1li2 (1.55e-5; the route 1.10e-5): that force is the small
# difference of the two parameterizations' larger ones
TREE_F32_BARS = dict(e_cav=1e-5, f_cav=3e-5, self_volume=1e-5, f_wu=1e-5)
# clock cycles the stream sleeps before the timed launches are queued
# behind it (~0.1 s at the H100's clock: longer than the host takes to
# queue the step's two passes)
TREE_SLEEP_CYCLES = 200_000_000
# launches of each tree kernel in the step's two passes (7 levels each)
TREE_PASS_LAUNCHES = dict(tree_rescan=14, tree_reduce=14, tree_deposit=2)


@contextlib.contextmanager
def without_kernel_prep():
    """Window builds inside give their topologies without the per-level
    kernels' prep (ops/tree.py::kernel_prep), so their tree passes run the
    torch twin."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    prep = T.kernel_prep
    T.kernel_prep = lambda topology: topology
    try:
        yield
    finally:
        T.kernel_prep = prep


def tree_case(dev, name, nrep):
    """What a window build gives the tree passes, f32 on the card, at
    md_sim's capacities: the replicas' union level-1 tables (the DMS state
    and jittered copies, ReplicaEnsemble.initial_states), the union's
    fixed topology and its compacted WU topology, each as the twin runs it
    (`twin_topo`, `twin_vt`) and with the kernels' prep (`topo`, `vt`),
    and a WU gamma per atom (numpy seed)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import union_arrays
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    sim = md_sim(dev, name)
    pos = ReplicaEnsemble(sim, nrep).initial_states(jitter=1e-3)[0]
    ff = sim.ff_state()
    vdw_caps = sim._ensure_vdw_caps()
    with without_kernel_prep():
        _, topo, vt, (counts, _, _, wu) = sim.window_build(pos, ff, vdw_caps)
    if (counts > torch.as_tensor(sim.agbnp.caps.caps, device=dev)).any() \
            or (wu > torch.as_tensor(sim._vdw_caps[1], device=dev)).any():
        raise AssertionError(f"[33] {name} x {nrep}: the window overflowed")
    a = union_arrays(sim.agbnp.arrays, nrep, pairs=False)
    pt = pos.reshape(-1, 3)
    gdr = a["gamma"] / sim.agbnp.params.roffset
    l1 = T.make_level1(pt, a["radii_large"], a["vol_large"], gdr,
                       a["ishydrogen"])
    v1 = T.make_level1(pt, a["radii_vdw"], a["vol_vdw"], -gdr,
                       a["ishydrogen"])
    gam = torch.as_tensor(np.random.default_rng(33).normal(
        0.0, 10.0, pt.shape[0]), dtype=torch.float32, device=dev)
    return dict(sim=sim, nrep=nrep, twin_topo=topo, twin_vt=vt,
                topo=T.kernel_prep(topo), vt=T.kernel_prep(vt), l1=l1, v1=v1,
                wu={**v1, "gamma1i": gam})


def tree_step_passes(c, twin=False):
    """The MD step's two tree passes on c's topologies: the cavity pass
    (rescan_volumes2 + reduce_tree2) and the compacted WU pass; on the
    kernel route, or with twin on the torch passes (the topologies
    without the kernels' prep)."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    topo, vt = ((c["twin_topo"], c["twin_vt"]) if twin
                else (c["topo"], c["vt"]))
    la, lb = T.rescan_volumes2(topo, c["l1"], c["v1"])
    r1, r2 = T.reduce_tree2(la, lb, c["l1"], c["v1"], nrep=c["nrep"])
    wu = c["wu"]
    rw = T.reduce_tree(T.rescan_volumes(vt, wu), wu, with_selfvol=False,
                       nrep=c["nrep"])
    return dict(e_cav=r1["energy"] + r2["energy"],
                f_cav=-(r1["dr"] + r2["dr"]), self_volume=r2["self_volume"],
                f_wu=rw["dr"])


def tree_bytes(c):
    """Bytes each tree kernel moves over the step's two passes, f32: each
    input byte read once, each output byte written once, the reductions
    reading the valid rows alone.  {kernel: bytes}."""
    out = dict.fromkeys(TREE_KERNELS, 0)
    natoms = c["l1"]["gv"].shape[0]
    for tp, k, sv in ((c["topo"], 2, 1), (c["vt"], 1, 0)):
        nch, ndep = 5 * k + sv, 3 * k + sv
        caps = [l["valid"].shape[0] for l in tp]
        valid = [int(l["bnd"]["starts"][-1]) for l in tp]
        parents = [natoms] + caps[:-1]
        for li, cap in enumerate(caps):
            width = 6 if li == 0 else 13
            out["tree_rescan"] += 4 * (k * (parents[li] * width + natoms * 6
                                            + cap * 13) + 2 * cap) + cap
            acc_in = nch * valid[li] if li + 1 < len(caps) else 0
            out["tree_reduce"] += 4 * (valid[li] * (14 * k + ndep) + acc_in
                                       + parents[li] * (nch + 1) + 1)
        out["tree_deposit"] += 4 * (sum(valid) * (ndep + 1) + natoms + 1
                                    + natoms * (nch + 2 * k)
                                    + natoms * (4 * k + sv))
    return out


def timed_passes(fn):
    """ms a call of fn, TREE_REPEATS calls between CUDA events after a
    warm-up call (the host's launches and the device's work both)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(TREE_REPEATS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TREE_REPEATS


def tree_device_ms(fn):
    """Device ms a launch of each tree kernel over one call of fn: a CUDA
    event recorded before and after each launch (each wrapper of
    ops/kernels/tree.py wrapped for the call), all queued behind
    TREE_SLEEP_CYCLES of torch.cuda._sleep so that the host's time between
    launches falls inside the sleep and not between an event pair.
    Returns ({kernel: (ms, launches timed)}, whether the host queued the
    whole call inside the sleep); ms None where it did not."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tree as TK

    events = {k: [] for k in TREE_WRAPPERS}
    saved = {k: getattr(TK, w) for k, w in TREE_WRAPPERS.items()}

    def timed(k):
        def call(*args, **kw):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out = saved[k](*args, **kw)
            t1.record()
            events[k].append((t0, t1))
            return out
        return call

    fn()
    torch.cuda.synchronize()
    s0, s1, done = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    try:
        for k, w in TREE_WRAPPERS.items():
            setattr(TK, w, timed(k))
        s0.record()
        torch.cuda._sleep(TREE_SLEEP_CYCLES)
        s1.record()
        h0 = time.perf_counter()
        fn()
        done.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
    finally:
        for k, w in TREE_WRAPPERS.items():
            setattr(TK, w, saved[k])
    queued = host_ms < s0.elapsed_time(s1)
    return {k: ((sum(a.elapsed_time(b) for a, b in ev) / len(ev)
                 if ev and queued else None), len(ev))
            for k, ev in events.items()}, queued


def tree_md_turn(c, steps, gen):
    """ms a step of `steps` MD steps of c's system (the Simulation's
    runner for one replica, ReplicaEnsemble's for more; 40-step windows)
    after a warm-up window, with the tree kernels' launches and the
    tree.kernel counters a step."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    sim, nrep = c["sim"], c["nrep"]
    if nrep == 1:
        run = sim.make_langevin_runner(neighbor_every=NEIGHBOR_EVERY)
        state = (sim.positions, sim.velocities)

        def go(st, n):
            pos, vel, e, diag = run(*st, n, generator=gen)
            return (pos, vel), e, diag
    else:
        ens = ReplicaEnsemble(sim, nrep)
        run = ens.make_runner(neighbor_every=NEIGHBOR_EVERY)
        state = ens.initial_states(jitter=1e-3)

        def go(st, n):
            st, (e, *diag) = run(st, n)
            return st, e, worst_replica(diag)
    state, _, _ = go(state, NEIGHBOR_EVERY)
    torch.cuda.synchronize()
    before = PK.launch_counts()
    with profiling.record():
        profiling.reset()
        t0 = time.perf_counter()
        state, e, diag = go(state, steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counters = [x["site"] for x in profiling.recorded()["counts"]
                    if x["name"] == "tree.kernel"]
    after = PK.launch_counts()
    if sim.overflow_report(*diag) or not bool(torch.isfinite(e).all()):
        raise AssertionError("[33] MD overflowed or gave non-finite "
                             "energies")
    launches = {k: (after[k] - before[k]) / steps for k in TREE_KERNELS}
    return ms, launches, len(counters) / steps


def phase_tree_kernels(dev, card):
    """Phase 33: the fixed-topology tree passes as per-level kernels at
    the MD cells' topologies (1li2, 2clr, 4 x 2clr; f32, a window build
    at md_sim's capacities): the MD step's cavity and WU passes on the
    route against the torch twin on the card and against the f64 twin
    (TREE_F32_BARS), twice bitwise; each kernel's device ms a launch
    (tree_device_ms) beside its bytes bound, the step's two passes' ms on
    the route and on the twin (CUDA events); then MD ms a step on the
    route and on the twin in turns in one process (the twin's window
    builds without_kernel_prep), the tree kernels' launches a step and
    the tree.kernel counters a step.  Returns (launches of the phase,
    kernel records: the 1li2 case's device ms, the cases beside)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    records = {k: dict(cases={}) for k in TREE_KERNELS}
    PK.reset_launch_counts()
    for name, nrep in TREE_CASES:
        label = f"{name} x {nrep}"
        c = tree_case(dev, name, nrep)
        got = tree_step_passes(c)
        again = tree_step_passes(c)
        twin = tree_step_passes(c, twin=True)
        c64 = {**c, **{k: {kk: (v.double() if torch.is_tensor(v)
                                and v.is_floating_point() else v)
                           for kk, v in c[k].items()}
                       for k in ("l1", "v1", "wu")}}
        ref = tree_step_passes(c64, twin=True)
        errs = {}
        for k, v in got.items():
            if not torch.equal(v, again[k]):
                raise AssertionError(f"[33] {label} {k}: two calls differ")
            scale = ref[k].abs().max() if k != "e_cav" else ref[k].abs()
            errs[k] = (float(((v.double() - ref[k]).abs() / scale).max()),
                       float(((twin[k].double() - ref[k]).abs()
                              / scale).max()),
                       float(((v - twin[k]).abs().double()
                              / scale).max()))
        log(f"[33] {label}: f32 route / f32 twin / route-twin, each against "
            f"max|f64 twin| (energy relative): "
            f"{ {k: tuple(f'{x:.2e}' for x in e) for k, e in errs.items()} }"
            f"; the route's bars {TREE_F32_BARS}")
        if any(e[0] > TREE_F32_BARS[k] for k, e in errs.items()):
            raise AssertionError(f"[33] {label}: the route vs f64")
        dev_ms, queued = tree_device_ms(lambda: tree_step_passes(c))
        nbytes = tree_bytes(c)
        route_ms = timed_passes(lambda: tree_step_passes(c))
        twin_ms = timed_passes(lambda: tree_step_passes(c, twin=True))
        for k in TREE_KERNELS:
            ms, seen = dev_ms[k]
            launches = TREE_PASS_LAUNCHES[k]
            if seen != launches:
                raise AssertionError(f"[33] {label} {k}: {seen} launches "
                                     f"timed, the passes make {launches}")
            bound = nbytes[k] / PEAK_BYTES * 1e3 / launches
            records[k]["cases"][label] = dict(
                ms=None if ms is None else round(ms, 5),
                bound_ms=round(bound, 6), launches=launches,
                bytes=nbytes[k], passes_ms=round(route_ms, 4),
                plain_passes_ms=round(twin_ms, 4))
            shown = "not measured" if ms is None else f"{ms:.4f}"
            log(f"    {k:13s} {label}: {shown} device ms a launch (CUDA "
                f"events, the mean of the passes' {launches}), bound "
                f"{bound:.5f} ms ({nbytes[k]} bytes / 3.35 TB/s, the "
                f"levels' tables as if read from HBM)")
        if not queued:
            log(f"    {label}: the host did not queue the passes inside "
                f"the sleep: device ms not measured")
        log(f"    {label}: the step's two tree passes {route_ms:.3f} ms on "
            f"the route, {twin_ms:.3f} ms on the torch twin (CUDA events, "
            f"{TREE_REPEATS} repeats) on {card}")
        turns = {"route": [], "twin": []}
        gen = torch.Generator(device=dev).manual_seed(33)
        for _ in range(TREE_TURNS):
            turns["route"].append(tree_md_turn(c, TREE_MD_STEPS, gen))
            with without_kernel_prep():
                turns["twin"].append(tree_md_turn(c, TREE_MD_STEPS, gen))
        r_ms = [t[0] for t in turns["route"]]
        w_ms = [t[0] for t in turns["twin"]]
        launches, counters = turns["route"][0][1], turns["route"][0][2]
        log(f"    {label} MD ({TREE_MD_STEPS} steps a turn, 40-step "
            f"windows): route {[round(x, 2) for x in r_ms]} ms/step, twin "
            f"{[round(x, 2) for x in w_ms]} ms/step; tree kernel launches a "
            f"step {launches}, tree.kernel counters a step {counters}; "
            f"twin turns {turns['twin'][0][1]}")
        # two passes a step; each window's build rescans once more
        lv = T.NUM_TREE_LEVELS
        want = dict(tree_rescan=2 * lv + lv / NEIGHBOR_EVERY,
                    tree_reduce=2 * lv, tree_deposit=2)
        if any(abs(launches[k] - v) > 1e-9 for k, v in want.items()) \
                or abs(counters - sum(want.values())) > 1e-9 \
                or any(v for v in turns["twin"][0][1].values()):
            raise AssertionError(f"[33] {label}: the route did not engage "
                                 "on every pass, or the twin launched it")
        for k in TREE_KERNELS:
            records[k]["cases"][label].update(
                launches_per_step=launches[k], md_ms=r_ms, twin_md_ms=w_ms)
        del c
        torch.cuda.empty_cache()
    counts = PK.launch_counts()
    for k in TREE_KERNELS:
        cases = records[k]["cases"]
        first = cases["1li2 x 1"]
        records[k].update(ms=first["ms"], bound_ms=first["bound_ms"],
                          plain_ms=first["plain_passes_ms"], library_ms=None,
                          max_abs_err=None, bound_by="bytes",
                          library="none: no PyTorch call fuses a tree level")
    return counts, records


def log_phase_times():
    """Wrap every phase_* function so that it logs its own wall time (the
    smoke's budget is the sum of them)."""
    def timed(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log(f"    {fn.__name__} took {time.perf_counter() - t0:.1f} s")
            return out
        return call

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(fn)

GRAPH_STEPS = 160       # [34] timed steps a turn (four rebuild windows)
GRAPH_TURNS = ("eager", "graph", "graph", "eager")
GRAPH_CASES = (("1li2", 1, 1, 1), ("2clr", 1, 1, 1), ("2clr", 4, 1, 1),
               ("1li2", 1, 2, 1), ("1li2", 1, 1, 4))
# (system, replicas, AGBNP version, wu_every): the last, the WU impulse
# every 4 steps, two step kinds, each captured once
GRAPH_KEEP_WINDOWS = 10  # [34] windows a turn of the kept-graph cases
GRAPH_KEEP_TURNS = ("anew", "kept", "kept", "anew")
GRAPH_KEEP_CASES = (("1li2", 1), ("1li2", 4))  # (system, wu_every)


@contextlib.contextmanager
def eager_windows():
    """Rebuild windows inside run their steps and their builds eagerly
    (md/graphs.py's capturable declines; a runner's BuildGraph runs each
    build as it comes)."""
    from openmm_agbnp_plugin_tpu_torch.md import graphs

    real, call = graphs.capturable, graphs.BuildGraph.__call__
    graphs.capturable = lambda *a: False
    graphs.BuildGraph.__call__ = lambda self, build, pos: build(pos)
    try:
        yield
    finally:
        graphs.capturable = real
        graphs.BuildGraph.__call__ = call


@contextlib.contextmanager
def capture_every_window():
    """A runner's windows capture their graphs anew, one capture a step
    kind a window, as before the graphs were kept across windows
    (md/graphs.py's WindowGraphs forgets its slots at every window)."""
    from openmm_agbnp_plugin_tpu_torch.md import graphs

    real = graphs.WindowGraphs.bind

    def bind(self, make, inputs):
        self.key = None
        return real(self, make, inputs)

    graphs.WindowGraphs.bind = bind
    try:
        yield
    finally:
        graphs.WindowGraphs.bind = real


def same_bits(x, y, what):
    """x and y (nested tuples, lists and tensors) equal bit for bit."""
    import torch

    if isinstance(x, torch.Tensor):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: not bitwise equal")
    elif isinstance(x, (tuple, list)):
        for k, (a, b) in enumerate(zip(x, y)):
            same_bits(a, b, f"{what}[{k}]")
    elif x != y:
        raise AssertionError(f"{what}: {x!r} != {y!r}")


def phase_graphs(dev, card):
    """Phase 34: a runner's CUDA graphs, kept across its windows
    (md/graphs.py).  For each of GRAPH_CASES, a runner's warm-up window
    and then GRAPH_STEPS timed steps from the same start and noise, eager
    and graphed in turns: wall and CUDA-event ms a step, the replayed
    steps (every timed step of a graphed turn: the first graphed turn's
    warm-up window captured the graphs), every turn's results bitwise the
    first turn's, the launch tallies equal; for each of GRAPH_KEEP_CASES,
    phase_kept_graphs; then one 1li2 window step of AGBNP1 and one of
    AGBNP2 eagerly and as a captured and replayed graph under
    set_sync_debug_mode("error"), bitwise each other.  Returns the
    graphed turns' launches of the 1li2 case."""
    import statistics

    import torch

    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.md import graphs
    from openmm_agbnp_plugin_tpu_torch.md.integrators import \
        langevin_middle_step
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        worst_replica
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    log(f"[34] torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    first_launches = None
    for name, nrep, version, wu in GRAPH_CASES:
        sim = md_sim(dev, name) if version == 1 else v2_sim(dev, name)
        label = name if nrep == 1 else f"{nrep} x {name}"
        label += "" if version == 1 else f" v{version}"
        label += "" if wu == 1 else f" wu{wu}"
        if nrep == 1:
            run = sim.make_langevin_runner(neighbor_every=NEIGHBOR_EVERY,
                                           wu_every=wu)

            def go(steps, seed):
                gen = torch.Generator(device=dev).manual_seed(seed)
                pos, vel, e, diag = run(sim.positions, sim.velocities,
                                        steps, generator=gen)
                return (pos, vel, e, diag), diag
        else:
            ens = ReplicaEnsemble(sim, nrep)
            run = ens.make_runner(neighbor_every=NEIGHBOR_EVERY)

            def go(steps, seed):
                states, out = run(ens.initial_states(jitter=1e-3,
                                                     seed=seed), steps)
                return (states[0], states[1], *out), worst_replica(out[1:])

        ms = dict(eager=[], graph=[])
        replayed = {}
        first = None
        for turn in GRAPH_TURNS:
            ctx = eager_windows() if turn == "eager" else \
                contextlib.nullcontext()
            with ctx:
                go(NEIGHBOR_EVERY, 1)
                torch.cuda.synchronize()
                PK.reset_launch_counts()
                profiling.reset()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                with profiling.record():
                    t0 = time.perf_counter()
                    ev[0].record()
                    out, diag = go(GRAPH_STEPS, 2)
                    ev[1].record()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / GRAPH_STEPS
                rec = profiling.recorded()
                profiling.reset()
            launches = PK.launch_counts()
            replays = sum(c["n"] for c in rec["counts"]
                          if c["name"] == "md.graph_replay")
            want = 0 if turn == "eager" else GRAPH_STEPS
            replayed[turn] = replays
            if replays != want:
                raise AssertionError(f"[34] {label} {turn}: {replays} "
                                     f"replayed steps, expected {want}")
            report = sim.overflow_report(*diag)
            if report:
                raise AssertionError(f"[34] {label}: overflow {report}")
            ms[turn].append((wall, ev[0].elapsed_time(ev[1]) / GRAPH_STEPS))
            if first is None:
                first = (out, launches)
            else:
                same_bits(first[0], out, f"[34] {label} {turn}")
                if launches != first[1]:
                    raise AssertionError(
                        f"[34] {label} {turn}: launches {launches} != "
                        f"{first[1]}")
            if first_launches is None and turn == "graph":
                first_launches = launches
        med = {t: (statistics.median(w for w, _ in v),
                   statistics.median(c for _, c in v)) for t, v in ms.items()}
        turns = {t: [(round(w, 4), round(c, 4)) for w, c in v]
                 for t, v in ms.items()}
        log(f"[34] {label}: ms a step (wall, CUDA events) by turn {turns}; "
            f"median eager {med['eager'][0]:.4f} / graph "
            f"{med['graph'][0]:.4f} wall, "
            f"x{med['eager'][0] / med['graph'][0]:.3f}; {replayed['graph']} "
            f"replayed of {GRAPH_STEPS} steps a graphed turn; every turn "
            f"bitwise the first, launches equal; {card}")
    for name, wu in GRAPH_KEEP_CASES:
        phase_kept_graphs(dev, card, name, wu)
    for sim, label in ((md_sim(dev, "1li2"), "1li2"),
                       (v2_sim(dev, "1li2", grow=False), "1li2 v2")):
        ff = sim.ff_state()
        pos, vel = sim.positions, sim.velocities
        if sim.agbnp2 is not None:
            pairs, topo = sim._v2_build(pos, ff)
            fn = sim.force_fn(pairs=pairs, topology=topo, ff=ff)
        else:
            pairs, topo, vt, _ = sim.window_build(pos[None], ff,
                                                  sim._ensure_vdw_caps())
            fn = sim.force_fn(pairs=pairs, topology=topo, ff=ff,
                              vdw_topology=vt)
        step = langevin_middle_step(fn, sim.masses, 0.001, 300.0, 1.0)
        noise = torch.randn(pos.shape, generator=torch.Generator(device=dev)
                            .manual_seed(1), dtype=pos.dtype, device=dev)
        step(pos, vel, noise)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = step(pos, vel, noise)
            got = graphs.StepGraph(step, pos, vel, noise)(noise)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        same_bits(tuple(want), tuple(got), f"[34] the graphed {label} "
                  "step")
        log(f"[34] a {label} window step, eager and captured + replayed, "
            "ran under set_sync_debug_mode('error'): no host sync; bitwise "
            "equal")
    return first_launches


def phase_kept_graphs(dev, card, name, wu):
    """[34]'s kept-graph case: GRAPH_KEEP_WINDOWS windows of a system
    (wu_every wu) from its DMS state, after a run_md of the same
    trajectory that grows its capacities, a fresh runner a turn, the
    graphs kept across the windows or captured anew every window in
    turns (GRAPH_KEEP_TURNS): wall and CUDA-event ms a step, the captures
    (the step kinds once, or every window) and reuses (every window after
    the first, or none) counted, every turn bitwise the first."""
    import statistics

    import torch

    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    sim = md_sim(dev, name)
    label = name + ("" if wu == 1 else f" wu{wu}")
    steps = GRAPH_KEEP_WINDOWS * NEIGHBOR_EVERY
    kinds = 1 if wu == 1 else 2

    def gen():
        return torch.Generator(device=dev).manual_seed(3)

    sim.run_md(steps, neighbor_every=NEIGHBOR_EVERY, wu_every=wu,
               generator=gen())
    ms = dict(anew=[], kept=[])
    first = None
    for turn in GRAPH_KEEP_TURNS:
        run = sim.make_langevin_runner(neighbor_every=NEIGHBOR_EVERY,
                                       wu_every=wu)
        ctx = capture_every_window() if turn == "anew" else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        profiling.reset()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with ctx, profiling.record():
            t0 = time.perf_counter()
            ev[0].record()
            out = run(sim.positions, sim.velocities, steps, generator=gen())
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        rec = profiling.recorded()
        profiling.reset()
        got = tuple(sum(c["n"] for c in rec["counts"] if c["name"] == k)
                    for k in ("md.graph_capture", "md.graph_reuse"))
        want = ((kinds, GRAPH_KEEP_WINDOWS - 1) if turn == "kept"
                else (kinds * GRAPH_KEEP_WINDOWS, 0))
        if got != want:
            raise AssertionError(f"[34] {label} {turn}: captures, reuses "
                                 f"{got}, expected {want}")
        report = sim.overflow_report(*out[3])
        if report:
            raise AssertionError(f"[34] {label} {turn}: overflow {report}")
        ms[turn].append((wall, ev[0].elapsed_time(ev[1]) / steps))
        if first is None:
            first = out
        else:
            same_bits(first, out, f"[34] {label} {turn}")
    med = {t: statistics.median(w for w, _ in v) for t, v in ms.items()}
    turns = {t: [(round(w, 4), round(c, 4)) for w, c in v]
             for t, v in ms.items()}
    log(f"[34] {label}, {GRAPH_KEEP_WINDOWS} windows of {NEIGHBOR_EVERY} "
        f"steps from a fresh runner: ms a step (wall, CUDA events) by turn "
        f"{turns}; median captured anew {med['anew']:.4f} / kept "
        f"{med['kept']:.4f} wall, x{med['anew'] / med['kept']:.3f}; "
        f"captures {kinds * GRAPH_KEEP_WINDOWS} / {kinds}, reuses 0 / "
        f"{GRAPH_KEEP_WINDOWS - 1}; every turn bitwise the first; {card}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", type=int, choices=(9, 25, 31, 32, 33, 34),
                    help="build the kernels and run this phase alone "
                         "(its launches and kernel records, the card's "
                         "line, then {\"ok_phase\": N}; the contract's "
                         "ok line is the full run's alone)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import openmm_agbnp_plugin_tpu_torch  # noqa: F401  (fails outside repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[1] {card}")
    dev = torch.device("cuda", 0)
    log_phase_times()
    phase_build()
    if args.only is not None:
        records = {}
        if args.only == 31:
            paths, records = phase_large(dev, card)
        elif args.only == 25:
            paths = dict(synth10k=phase_synthetic(dev, card))
        elif args.only == 33:
            tree_counts, records = phase_tree_kernels(dev, card)
            paths = dict(tree=tree_counts)
        elif args.only == 34:
            paths = dict(graphs=phase_graphs(dev, card))
        elif args.only == 9:
            paths = dict(mts4fs=phase_mts4_constraints(dev, card))
        else:
            paths = dict(freevol=phase_freevol(dev, card))
        log(f"[{args.only}] passed in {time.perf_counter() - t0:.1f} s")
        print(json.dumps(dict(phase=args.only, launches=paths,
                              kernels=records)))
        print(card)
        print(json.dumps(dict(ok_phase=args.only)), flush=True)
        return 0
    kernels = phase_kernels(dev)
    phase_goldens(dev)
    counts = dict(share_off=phase_parity(dev))
    counts["md_1li2"], counts["md_2clr"] = phase_md(dev, card)
    sim_1li2, counts["mts_wu4"] = phase_mts_wu4(dev, card)
    counts["mts4fs"] = phase_mts4_constraints(dev, card)
    phase_no_sync(dev, sim_1li2)
    phase_resume(dev, sim_1li2)
    phase_context(dev)
    counts["row_probes"] = phase_row_probes(dev, card)
    counts["md_v2"] = phase_v2(dev, card)
    sim_ens, counts["ens_1li2"], ens_window = phase_ensemble(dev, card)
    counts["ens_2clr"] = phase_ensemble_2clr(dev, card)
    counts["remd"] = phase_remd(dev, card, sim_ens, ens_window)
    score_counts = phase_scoring(dev, card)
    new_paths = dict(param_grads=phase_param_grads(dev, card),
                     ens_constraints=phase_constrained_replicas(dev, card),
                     per_step=phase_per_step(dev, card),
                     options=phase_options(dev, card))
    v2_paths = dict(score_v2=phase_score_v2(dev, card),
                    per_step_v2=phase_per_step_v2(dev, card),
                    synth10k=phase_synthetic(dev, card))
    port_paths = dict(native=phase_native(dev, card),
                      examples=phase_examples(dev, card),
                      sharding=phase_sharding(dev, card))
    last_paths = dict(mixed=phase_mixed(dev, card),
                      oracle=phase_oracle(dev, card))
    large_paths, large_records = phase_large(dev, card)
    freevol_counts = phase_freevol(dev, card)
    counts["tree"], tree_records = phase_tree_kernels(dev, card)
    kernels.update(tree_records)
    phase_graphs(dev, card)
    if "jax" in sys.modules or "openmm_agbnp_plugin_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    # each MD run counts a warm-up and a timed run of its (outer) steps
    md_steps = dict(md_1li2=2 * MD_STEPS, md_2clr=2 * MD_STEPS_2CLR,
                    mts_wu4=2 * MTS_WU4_STEPS, mts4fs=2 * MTS4_STEPS,
                    md_v2=2 * V2_STEPS,
                    ens_1li2=ENS_WARMUP + ENS_STEPS,
                    ens_2clr=ENS_WARMUP + ENS_2CLR_STEPS,
                    remd=(REMD_WARM + REMD_CYCLES) * REMD_SPC)
    record = []
    for name, (src, replaces, path) in KERNELS.items():
        launches = counts[path][name]
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on its path {path}")
        k = kernels[name]
        per_step = {p: counts[p][name] / s for p, s in md_steps.items()}
        log(f"    {name:27s} launches per (outer) step "
            f"{ {p: round(v, 3) for p, v in per_step.items()} }")
        rec = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=launches, max_abs_err=k["max_abs_err"],
                   ms=k["ms"], plain_ms=k["plain_ms"],
                   bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                   library_ms=k["library_ms"],
                   library=k.get("library", LIBRARY_NONE),
                   launches_per_step=per_step)
        # the replica paths: launches a step of R replicas' MD ([15] R = 8,
        # [16], [17]; within the per-step dict above) and of one batched
        # score of [18] (NoCutoff + CutoffNonPeriodic)
        rec["launches_score_b16"] = score_counts.get(name, 0)
        # launches on the paths [19]-[22]: gradients, constrained replicas,
        # the per-step path and sites, the Simulation options
        rec["launches_19_22"] = {p: c.get(name, 0)
                                 for p, c in new_paths.items()}
        # and on [23]-[25]: the v2 scorer's counted call (8 poses), the
        # per-step v2 runs (R = 1 and 4, 12 steps each), the synthetic
        # ball's MD (every attempt's warm-up and timed run)
        rec["launches_23_25"] = {p: c.get(name, 0)
                                 for p, c in v2_paths.items()}
        # and on [26]-[28]: the 1li2 evaluation held against the native
        # engine, the examples run in this process, the ranks of [28]
        rec["launches_26_28"] = {p: c.get(name, 0)
                                 for p, c in port_paths.items()}
        # and on [29]-[30]: the mixed MD runs and scoring, the card's
        # evaluations held against the f64 oracles
        rec["launches_29_30"] = {p: c.get(name, 0)
                                 for p, c in last_paths.items()}
        # and on [31]: the 16,384-atom MD (every attempt's warm-up and
        # timed run) and the 24,576-atom evaluations (the PanicButton
        # loop, the timed ones, the share_qd=False one); the kernel's
        # times at the 24,576-atom evaluation's shapes
        rec["launches_31"] = {p: c.get(name, 0)
                              for p, c in large_paths.items()}
        if name in large_records:
            rec["synth_24k"] = large_records[name]
        # and on [32]: the free-volume reductions
        rec["launches_32"] = freevol_counts.get(name, 0)
        if "live_pairs" in k:
            rec["live_pairs"] = k["live_pairs"]
        rec.update({x: k[x] for x in RECORD_EXTRAS if x in k})
        for sub in ("lists_1li2", "dense_1li2"):
            if sub in k:
                rec[sub] = {x: v for x, v in k[sub].items()
                            if x != "library_ms"}
        record.append(rec)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(kernels=record)))
    print(card)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

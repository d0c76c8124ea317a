"""The port's synthetic protein-like ball (utils/synthetic.py) against the
JAX package's generator (benchmarks/synthetic_scale.py), f64 on the CPU.

The generator's arrays are bitwise the reference's at 600 and 3,200
atoms; the port's Simulation of the 600-atom bonded ball (AGBNP1 + the MM
force field, 1 nm cutoff) gives JAX's energy and forces to 1e-10;
run_md drives it through benchmark_langevin with finite energies from
rest; and the windowed protocol (_run_md_windows) keeps the reference's
bookkeeping: fed JAX's velocities and key stream it regrows, times and
ends as JAX's does, and on its own it retries a window from the state it
saved, leaves the window after a regrow out of the timing and shrinks to
fit once after a heat phase that regrew.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu_torch import Simulation
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "synthetic_scale.py")


@pytest.fixture(scope="module")
def ref():
    """The reference generator module (its import sets JAX's compile
    cache directory, which is put back)."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("synthetic_scale_ref", REF)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def _same(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape, what
    assert np.array_equal(x, y), what


@pytest.mark.parametrize("natoms", [600, 3200])
def test_generator_is_bitwise_the_reference(ref, natoms):
    for i, (x, y) in enumerate(zip(synthetic.synthetic_system(natoms),
                                   ref.synthetic_system(natoms))):
        _same(x, y, i)
    ns, rs = synthetic.synthetic_dms(natoms), ref.synthetic_dms(natoms)
    assert sorted(vars(ns)) == sorted(vars(rs))
    for k, v in vars(rs).items():
        if k == "n":
            assert ns.n == v == natoms
        else:
            _same(getattr(ns, k), v, k)


def test_simulation_force_on_the_ball_matches_jax(ref):
    """The all-pairs force (AGBNP1 + the MM force field, 1 nm cutoff) of the
    port's Simulation built from the duck-typed ball against JAX's
    Simulation of the reference's ball, at JAX's tree capacities."""
    jsim = JaxSimulation(ref.synthetic_dms(600), version=1, cutoff=1.0,
                         dtype=np.float64, pair_tiles=False)
    caps = jsim.agbnp.caps
    tsim = Simulation(synthetic.synthetic_dms(600), device="cpu", version=1,
                      cutoff=1.0, dtype=torch.float64,
                      caps=T.TreeCaps(tuple(caps.caps), tuple(caps.offs)))
    assert tsim.kmax == jsim.kmax
    e_j, f_j, c_j = (np.asarray(x) for x in
                     jax.jit(jsim.force_fn())(jsim.positions))
    e_t, f_t, c_t = tsim.force_fn()(tsim.positions)
    np.testing.assert_array_equal(c_t.numpy()[:7], c_j[:7])
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_run_md_on_the_cpu():
    """run_md at 600 atoms on the CPU: 4 timed steps after 4, rebuilds
    every 2, finite energies, no overflow left, the windows counted."""
    res = synthetic.run_md(600, nsteps=4, device="cpu", neighbor_every=2)
    assert res["sim"].dtype == torch.float64
    assert res["steps_run"] == 4 and res["windows"] == 2
    assert not res["overflow"] and np.isfinite(res["energies"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.run_md(600, nsteps=1)


# ---------------------------------------------------------------------------
# The windowed large-N protocol (_run_md_windows) on the 600-atom ball
# ---------------------------------------------------------------------------

def _windows_spy(sim, record, regrows):
    """Wrap sim.make_langevin_runner so every window the protocol runs is
    recorded (its inputs, the generator's state at its start, its outputs
    and overflow report), and the first window after each regrow is run
    again on a fresh runner at the grown capacities from the recorded
    start (recorded as "fresh")."""
    make = sim.make_langevin_runner

    def spy(*args, **kw):
        run = make(*args, **kw)

        def recorded(pos, vel, nsteps, generator=None):
            state = generator.get_state()
            out = run(pos, vel, nsteps, generator=generator)
            w = dict(pos=pos, vel=vel, state=state, out=out,
                     rep=sim.overflow_report(*out[3]))
            if regrows and regrows[-1][0] == len(record):
                gen = torch.Generator().manual_seed(12345)
                gen.set_state(state)
                w["fresh"] = make(*args, **kw)(pos, vel, nsteps,
                                               generator=gen)
            record.append(w)
            return out

        return recorded

    sim.make_langevin_runner = spy


class _JaxKeys:
    """A JAX PRNG key as the protocol's generator: get_state/set_state
    save and restore the key, and take(n) gives the noise of n steps as
    JAX's runner splits it off the key."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def get_state(self):
        return self.key

    def set_state(self, key):
        self.key = key

    def take(self, count, shape):
        out = []
        for _ in range(count):
            self.key, sub = jax.random.split(self.key)
            out.append(np.asarray(jax.random.normal(sub, shape,
                                                    dtype=jnp.float64)))
        return torch.as_tensor(np.stack(out))


def test_windows_match_the_reference(ref, monkeypatch):
    """The port's _run_md_windows against the reference's on the 600-atom
    ball (f64, default capacities, 300 K; 12 steps in 2-step windows, 2 of
    them heat): the port is given JAX's seed-1 velocities and draws each
    window's noise from JAX's key as the reference's runner does, its
    generator saved and restored around a retry.  Then both regrow the
    same channels in the same windows, time and count the same windows,
    end with the same capacities, and every window's energies agree to
    1e-10 (the first window's first energy is the reference's
    -325263.78775501)."""
    jsim = JaxSimulation(ref.synthetic_dms(600), version=1, cutoff=1.0,
                         dtype=np.float64, include_mm=True)
    jwin = []
    jmake = jsim.make_langevin_runner

    def jspy(*args, **kw):
        run = jmake(*args, **kw)

        def recorded(pos, vel, key, nsteps):
            out = run(pos, vel, key, nsteps)
            jwin.append((np.asarray(out[3]), jsim.overflow_report(
                np.asarray(out[4][0]), out[4][1], np.asarray(out[4][2]),
                np.asarray(out[4][3]))))
            return out

        return recorded

    jsim.make_langevin_runner = jspy
    rj = ref._run_md_windows(jsim, 12, 2, 1, heat_windows=2)

    tsim = Simulation(synthetic.synthetic_dms(600), device="cpu", version=1,
                      cutoff=1.0, dtype=torch.float64)
    monkeypatch.setattr(tsim, "set_velocities_to_temperature",
                        lambda t, seed: setattr(tsim, "velocities",
                                                torch.tensor(np.asarray(
                                                    jsim.velocities))))
    keys = _JaxKeys(0)
    twin = []
    tmake = tsim.make_langevin_runner

    def tspy(*args, **kw):
        run = tmake(*args, **kw)

        def fed(pos, vel, nsteps, generator=None):
            assert generator is keys
            out = run(pos, vel, nsteps, noise=keys.take(nsteps, pos.shape))
            twin.append((out[2].numpy(), tsim.overflow_report(*out[3])))
            return out

        return fed

    tsim.make_langevin_runner = tspy
    rt = synthetic._run_md_windows(tsim, 12, 2, heat_windows=2,
                                   generator=keys)

    for k in ("windows", "steps_done", "regrows", "overflow"):
        assert rt[k] == rj[k], k
    assert rt["regrows"] > 0  # the reference's run regrows too
    assert rt["steps_run"] == 2 * len(twin)
    assert (tsim.agbnp.caps.caps, tsim.agbnp.caps.offs) == (
        tuple(jsim.agbnp.caps.caps), tuple(jsim.agbnp.caps.offs))
    assert tsim.kmax == jsim.kmax
    assert tsim._vdw_caps == (jsim._vdw_caps[0], tuple(jsim._vdw_caps[1]))
    assert abs(twin[0][0][0] - (-325263.78775501)) <= 1e-10 * 325263.8
    assert len(twin) == len(jwin)
    for (et, rep_t), (ej, rep_j) in zip(twin, jwin):
        assert rep_t == rep_j
        assert np.abs(et - ej).max() <= 1e-10 * np.abs(ej).max()
    np.testing.assert_allclose(rt["energies"], rj["energies"], rtol=1e-10)


def _ball(**kw):
    return Simulation(synthetic.synthetic_dms(600), device="cpu", version=1,
                      cutoff=1.0, dtype=torch.float64, **kw)


def test_windows_regrow_retry_and_shrink():
    """The port alone from kmax=104 (half its sizing; the reference's
    rebuilt runner raises after this regrow): the first window overflows
    neighbor_kmax and regrows with headroom 1.3 (then 1.3 x 1.25^k); each
    retry starts from the failed attempt's positions, velocities and
    generator state and is bitwise a fresh runner's at the grown
    capacities; a heat phase that regrew is followed by one shrink-to-fit
    from its last positions; a timed window that regrew is not timed; and
    max_regrow=0 raises naming neighbor_kmax."""
    for heat in (2, 0):
        sim = _ball(kmax=104)
        wins, regrows, shrinks = [], [], []
        _windows_spy(sim, wins, regrows)
        regrow, resize = sim._regrow, sim.resize_caps_to_current

        def spy_regrow(*args, headroom, _regrow=regrow, _wins=wins,
                       _regrows=regrows):
            _regrows.append((len(_wins), headroom))
            return _regrow(*args, headroom=headroom)

        def spy_resize(pos, _resize=resize, _wins=wins, _shrinks=shrinks):
            _shrinks.append((len(_wins), pos))
            return _resize(pos)

        sim._regrow, sim.resize_caps_to_current = spy_regrow, spy_resize
        res = synthetic._run_md_windows(sim, 4 + 2 * heat, 2,
                                        heat_windows=heat)
        assert wins[0]["rep"]["neighbor_kmax"] == (134, 104)
        assert regrows[0] == (1, 1.3) and res["regrows"] == len(regrows)
        assert [h for _, h in regrows] == [
            min(1.3 * 1.25 ** k, 2.6) for k in range(len(regrows))]
        assert sim.kmax >= 134 and not res["overflow"]
        for i, _ in regrows:  # each retry against its failed attempt
            failed, retry = wins[i - 1], wins[i]
            assert failed["rep"]
            assert retry["pos"] is failed["pos"]
            assert retry["vel"] is failed["vel"]
            assert torch.equal(retry["state"], failed["state"])
            for x, y in zip(retry["out"][:3], retry["fresh"][:3]):
                assert torch.equal(x, y)
        assert res["steps_run"] == 2 * len(wins)
        clean = [i for i, w in enumerate(wins) if not w["rep"]]
        clean_all = list(clean)
        if heat:
            assert len(shrinks) == 1
            nheat = shrinks[0][0]
            assert clean.index(nheat - 1) == heat - 1
            assert torch.equal(shrinks[0][1], wins[nheat - 1]["out"][0])
            clean = clean[heat:]
        else:
            assert not shrinks
        assert len(clean) == 2
        after = {i for i, _ in regrows}
        assert res["windows"] == sum(i not in after for i in clean)
        if not heat:  # timed window 0 regrew: one window timed at most
            assert res["windows"] <= 1
        assert res["steps_done"] == (res["windows"] + heat) * 2
        assert [w[0] for w in res["window_log"]] == [
            f"heat window {k}" for k in range(heat)] + [
            f"timed window {k}" for k in range(2)]
        for (_, e0, e1, temp), i in zip(res["window_log"], clean_all):
            assert e0 == float(wins[i]["out"][2][0])
            assert e1 == float(wins[i]["out"][2][-1]) and temp > 300.0
        np.testing.assert_array_equal(res["energies"],
                                      wins[-1]["out"][2].numpy())

    sim = _ball(kmax=104)
    with pytest.raises(RuntimeError, match="neighbor_kmax"):
        synthetic._run_md_windows(sim, 4, 2, heat_windows=0, max_regrow=0)


def test_windows_stop_on_non_finite_dynamics():
    """A window that did not overflow but whose energies are not finite (a
    blown-up trajectory, made here by the runner's output) raises at once,
    naming the window, instead of being timed or regrown; the message
    carries the clean windows before it."""
    sim = _ball()
    make = sim.make_langevin_runner
    seen = []

    def poisoned(*args, **kw):
        run = make(*args, **kw)

        def step(pos, vel, nsteps, generator=None):
            out = run(pos, vel, nsteps, generator=generator)
            seen.append(sim.overflow_report(*out[3]))
            if len(seen) == 2:
                return (out[0], out[1], out[2] * float("nan"), out[3])
            return out

        return step

    sim.make_langevin_runner = poisoned
    with pytest.raises(RuntimeError, match="heat window 1: non-finite") as \
            err:
        synthetic._run_md_windows(sim, 8, 2, heat_windows=2)
    assert seen == [{}, {}] and "'heat window 0'" in str(err.value)


def test_run_md_picks_the_protocol_by_size(monkeypatch):
    """Up to WINDOWED_ATOMS atoms run_md starts from the generator's zero
    velocities and calls benchmark_langevin with its default max_regrow
    (3); above it runs _run_md_windows (the switch lowered to 500 here)."""
    import inspect

    params = inspect.signature(Simulation.benchmark_langevin).parameters
    assert params["max_regrow"].default == 3
    seen, windowed = {}, []

    def bench(self, **kw):
        seen.update(kw, vel=self.velocities.clone())
        return dict(steps_run=kw["nsteps"])

    def windows(sim, nsteps, neighbor_every):
        windowed.append((sim, nsteps, neighbor_every))
        return dict(windows=0)

    monkeypatch.setattr(Simulation, "benchmark_langevin", bench)
    monkeypatch.setattr(synthetic, "_run_md_windows", windows)
    res = synthetic.run_md(600, nsteps=4, device="cpu", neighbor_every=2)
    assert "max_regrow" not in seen and seen["nsteps"] == 4
    assert seen["neighbor_every"] == 2 and seen["temperature"] == 300.0
    assert seen["vel"].shape == (600, 3) and not seen["vel"].any()
    assert res["windows"] == 2 and not windowed
    seen.clear()
    monkeypatch.setattr(synthetic, "WINDOWED_ATOMS", 500)
    res = synthetic.run_md(600, nsteps=8, device="cpu", neighbor_every=2)
    assert not seen and windowed == [(res["sim"], 8, 2)]
    assert res["natoms"] == 600

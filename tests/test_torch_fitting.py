"""The port's parameter gradients (api/fitting.py, ParameterGradients)
against finite differences and against the JAX package's, f64 on the
CPU, on the first 48 atoms of tests/fixtures/gaussvol.dat (the set-up of
tests/test_fitting.py, whose five cases this file mirrors; the charge
case and the recovery fit are slow there and here)."""

import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
    ParameterGradients, load_gaussvol_dat
from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

torch.set_num_threads(2)

NATOMS = 48


@pytest.fixture(scope="module")
def fit_system(fixture_dir):
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(fixture_dir, "gaussvol.dat"))
    n = NATOMS
    params = AGBNPParams(radius=radius[:n], gamma=gamma[:n], alpha=alpha[:n],
                         charge=charge[:n], ishydrogen=ish[:n])
    model = AGBNPModel(params, device="cpu", dtype=torch.float64, version=1,
                       pair_kernel=False, positions=pos[:n])
    return model, pos[:n]


@pytest.mark.parametrize("key", [
    "gamma",
    "alpha",
    pytest.param("charge", marks=pytest.mark.slow),
])
def test_param_grads_match_fd(fit_system, key):
    """Reverse-mode d(energy)/d(theta) equals central finite differences
    along a random direction, per pose (JAX's bar: rtol 5e-6, atol 1e-8);
    the hydrogens' gamma gradients are exactly zero."""
    model, pos = fit_system
    pg = ParameterGradients(model)
    rng = np.random.default_rng(3)
    poses = pos[None] + 0.005 * rng.standard_normal((2, *pos.shape))

    theta = pg.initial_theta((key,))
    out = pg.energy_grads(theta, poses)
    grad = out[key].numpy()
    assert grad.shape == (2, model.params.n)

    direction = rng.standard_normal(model.params.n)
    if key == "gamma":
        assert (grad[:, np.asarray(model.params.ishydrogen) > 0] == 0).all()
    t = theta[key].numpy()
    h = 1e-5 * max(1.0, np.abs(t).max())
    ep = pg.energies({key: t + h * direction}, poses).numpy()
    em = pg.energies({key: t - h * direction}, poses).numpy()
    fd = (ep - em) / (2 * h)
    np.testing.assert_allclose(grad @ direction, fd, rtol=5e-6, atol=1e-8)


def test_unknown_parameter_rejected(fit_system):
    model, pos = fit_system
    pg = ParameterGradients(model)
    with pytest.raises(ValueError, match="unknown parameter"):
        pg.energies({"radius": np.ones(model.params.n)}, pos)


def test_kernel_route_rejected(fit_system):
    """The pair kernels carry no backward: a model on the kernel route is
    refused, as JAX refuses its Pallas route."""
    model, pos = fit_system
    kern = AGBNPModel(model.params, device="cpu", dtype=torch.float64,
                      version=1, positions=pos)
    assert kern.pair_pad > 0
    with pytest.raises(ValueError, match="pair_kernel=False"):
        ParameterGradients(kern)


def test_energy_grads_match_jax(fit_system):
    """Energies and per-pose gradients of all three parameters against the
    JAX package's ParameterGradients at the same theta: within 1e-10
    relative; the tree's row gathers ran through TakeRows' backward."""
    from openmm_agbnp_plugin_tpu.api.fitting import \
        ParameterGradients as JaxParameterGradients
    from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
        AGBNPModel as JaxAGBNPModel
    from openmm_agbnp_plugin_tpu.models.oracle import \
        AGBNPParams as JaxAGBNPParams

    model, pos = fit_system
    p = model.params
    jmodel = JaxAGBNPModel(JaxAGBNPParams(
        radius=p.radius, gamma=p.gamma, alpha=p.alpha, charge=p.charge,
        ishydrogen=p.ishydrogen), version=1, dtype=np.float64,
        pair_kernel=False, positions=pos)
    jpg = JaxParameterGradients(jmodel)
    pg = ParameterGradients(model)
    rng = np.random.default_rng(5)
    poses = pos[None] + 0.005 * rng.standard_normal((3, *pos.shape))
    # a theta away from the model's own arrays
    theta = {k: v * (1.0 + 0.1 * rng.standard_normal(v.shape))
             for k, v in jpg.initial_theta().items()}
    jout = jpg.energy_grads(theta, poses)
    calls = []
    backward = RW.take_rows_backward

    def counted(*args):
        calls.append(1)
        return backward(*args)

    RW.take_rows_backward = counted
    try:
        out = pg.energy_grads(theta, poses)
    finally:
        RW.take_rows_backward = backward
    assert calls
    for k in ("energy", "gamma", "alpha", "charge"):
        ref = np.asarray(jout[k])
        err = np.abs(out[k].numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-10, (k, err)
    es = pg.energies(theta, poses).numpy()
    assert np.abs(es - jout["energy"]).max() <= 1e-10 * np.abs(
        jout["energy"]).max()


def test_loss_grad_is_the_chain_of_per_pose_grads(fit_system):
    """make_loss_grad's one batched backward pass equals the chain rule
    over energy_grads' per-pose gradients."""
    model, pos = fit_system
    pg = ParameterGradients(model)
    rng = np.random.default_rng(7)
    poses = pos[None] + 0.005 * rng.standard_normal((3, *pos.shape))
    theta = pg.initial_theta(("gamma", "charge"))
    targets = torch.as_tensor(rng.standard_normal(3))
    out = pg.energy_grads(theta, poses)
    loss, grads = pg.make_loss_grad(
        lambda es: ((es - targets) ** 2).mean())(theta, poses)
    w = 2.0 * (out["energy"] - targets) / 3.0
    assert float(abs(loss - ((out["energy"] - targets) ** 2).mean())) \
        <= 1e-12 * float(loss)
    for k in ("gamma", "charge"):
        chain = (w[:, None] * out[k]).sum(0)
        err = float((grads[k] - chain).abs().max() / chain.abs().max())
        assert err <= 1e-12, (k, err)


@pytest.mark.slow
def test_fit_recovers_targets(fit_system):
    """End-to-end: optimize (gamma, alpha) with torch.optim.Adam under a
    cosine-decayed rate to match target energies generated at known
    parameters; the loss collapses (JAX's optax loop and bar)."""
    model, pos = fit_system
    pg = ParameterGradients(model)
    rng = np.random.default_rng(11)
    poses = pos[None] + 0.006 * rng.standard_normal((4, *pos.shape))

    true = pg.initial_theta(("gamma", "alpha"))
    targets = pg.energies(true, poses)
    theta = {k: (v * 1.15).requires_grad_(True) for k, v in true.items()}
    vg = pg.make_loss_grad(lambda es: ((es - targets) ** 2).mean())
    opt = torch.optim.Adam(list(theta.values()), lr=0.1)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=400)
    loss0 = None
    for _ in range(400):
        loss, grads = vg(theta, poses)
        if loss0 is None:
            loss0 = float(loss)
        for k, v in theta.items():
            v.grad = grads[k]
        opt.step()
        sched.step()
    assert float(loss) < 2e-4 * loss0, (loss0, float(loss))

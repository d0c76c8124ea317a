"""The port's four examples (openmm_agbnp_plugin_tpu_torch/examples), each
through its own main() on the CPU at tiny step counts, as
tests/test_example.py pins the JAX package's install example: a change to
a runner signature or an API an example touches fails here.  Each run
must return 0 and print finite energies."""

import re

import pytest

from openmm_agbnp_plugin_tpu_torch.examples import multichip_md, \
    remd_trpcage, rescore_conformers, test_agbnp

ENERGY = re.compile(r"(-?\d+\.\d+) kJ/mol")
MD_ENERGY = re.compile(r"E\[-?\d\]=(-?\d+\.\d+)")


def _finite_energies(text, least, pattern=ENERGY):
    found = [float(x) for x in pattern.findall(text)]
    assert len(found) >= least, text
    assert all(abs(x) < 1e7 for x in found), text


def test_install_example(monkeypatch, capsys):
    for k, v in (("AGBNP_TEST_LANGEVIN_STEPS", "20"),
                 ("AGBNP_TEST_VERLET_STEPS", "10"),
                 ("AGBNP_TEST_MINIMIZE_ITERS", "5"),
                 # a drift rate over 10 fs of an unequilibrated state is
                 # meaningless: the code path is what this pins
                 ("AGBNP_TEST_DRIFT_TOL", "1e9")):
        monkeypatch.setenv(k, v)
    assert test_agbnp.main("trpcage_agbnp1", "cpu") == 0
    out = capsys.readouterr().out
    assert "PASS" in out
    _finite_energies(out, 4)


def test_rescore_example(capsys):
    assert rescore_conformers.main(6, 1, "cpu") == 0
    out = capsys.readouterr().out
    assert "6 poses" in out
    _finite_energies(out, 1)


def test_remd_example(capsys):
    assert remd_trpcage.main(2, 4, "cpu") == 0
    out = capsys.readouterr().out
    assert "cycle 1:" in out
    _finite_energies(out, 1)


def test_multichip_example(capsys):
    """Two CPU ranks (gloo) on the atoms mesh, bitwise equal."""
    assert multichip_md.main(6, 2, "cpu") == 0
    out = capsys.readouterr().out
    assert "ranks bitwise equal" in out and "PASS" in out
    _finite_energies(out, 2, MD_ENERGY)


def test_examples_want_a_card_unless_told_otherwise():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (lambda: test_agbnp.main("trpcage_agbnp1"),
                 lambda: rescore_conformers.main(2, 1),
                 lambda: remd_trpcage.main(1, 2),
                 lambda: multichip_md.main(2, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()

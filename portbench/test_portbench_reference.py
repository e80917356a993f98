"""The plain references against NumPy at tiny sizes, and the control:
the reference in the type below the configuration's fails the limits
that the program's runs pass."""
import numpy as np
import pytest
import scipy.linalg
import torch

from portbench import harness, readings
from portbench.reference import lsms, parsec

LSMS = dict(n=24, nrhs=4, atoms_per_node=2, energies=3, tpool=3,
            dtype="complex128")
PARSEC = dict(ngrid=40, nstates=12, nblock=4, products_per_block=3,
              dtype="float64")


def test_lsms_reference_against_numpy():
    inputs = lsms.make_inputs(LSMS, {}, 5, "cpu")
    for step in range(7):
        atom, energy, ti, z = lsms.schedule(LSMS, step)
        assert (atom, energy, ti) == (step % 2, (step // 2) % 3, step % 3)
        t = inputs["t"][ti].numpy()
        m = np.eye(24) - z * (t @ inputs["g"][atom].numpy())
        want = scipy.linalg.lu_solve(scipy.linalg.lu_factor(m), t[:, :4])
        got = lsms.reference(LSMS, {}, inputs, step)["tau"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_lsms_inputs_follow_the_seed_and_the_proxy_scaling():
    a = lsms.make_inputs(LSMS, {}, 2 ** 31 + 9, "cpu")
    b = lsms.make_inputs(LSMS, {}, 2 ** 31 + 9, "cpu")
    c = lsms.make_inputs(LSMS, {}, 2 ** 31 + 10, "cpu")
    assert torch.equal(torch.stack(a["g"]), torch.stack(b["g"]))
    assert torch.equal(a["t"], b["t"])
    assert not torch.equal(a["g"][0], c["g"][0])
    # the inputs of some steps alone: the same draws, other G's dropped
    d = lsms.make_inputs(LSMS, {}, 2 ** 31 + 9, "cpu", steps=[3])
    assert d["g"][0] is None and torch.equal(d["g"][1], a["g"][1])
    assert torch.equal(d["t"], a["t"])
    # t = I + 0.01 X with X real; G's entries of variance 1 / (2 n^2)
    assert float(a["t"].imag.abs().max()) == 0.0
    assert float((a["t"] - torch.eye(24)).real.std()) == pytest.approx(
        0.01, rel=0.2)
    assert float(torch.stack(a["g"]).abs().pow(2).mean()) * 2 * 24 ** 2 == \
        pytest.approx(1.0, rel=0.2)


def test_parsec_reference_against_numpy():
    inputs = parsec.make_inputs(PARSEC, {}, 3, "cpu")
    psi = inputs["psi"].numpy()
    for step in range(8):
        assert parsec.block_of(PARSEC, step) == step % 3
        h = inputs["hpsi"][step % 3].numpy()
        got = parsec.reference(PARSEC, {}, inputs, step)
        np.testing.assert_allclose(got["s"].numpy(), h.T @ psi, atol=1e-12)


def test_parsec_compare_reads_every_product():
    """A step's products are stacked; one wrong product in the stack is
    what the number reads."""
    inputs = parsec.make_inputs(PARSEC, {}, 4, "cpu")
    want = parsec.reference(PARSEC, {}, inputs, 1)
    stack = want["s"].expand(3, -1, -1).clone()
    assert parsec.compare({"s": stack}, want) == {"s_err": 0.0}
    stack[1, 2, 5] += 1e-3 * want["s"].abs().max()
    assert parsec.compare({"s": stack}, want)["s_err"] == pytest.approx(
        1e-3)


@pytest.mark.parametrize("workload,size", [("lsms.resident", LSMS),
                                           ("parsec.resident", PARSEC)])
def test_control_fails_the_limits_the_program_passes(workload, size):
    """Each cell's limits, at a tiny size on the CPU: the program's
    reading under them, every control's over one of them."""
    cell = harness.load_cell(workload)
    cfg = {**cell.config, **size, "warmup_steps": 2}
    cfg["session"] = {**cfg["session"], "threshold": 1.0,
                      "lapack_nb": 8}
    cell = harness.Cell(cell.name, 1, cfg, {**cell.traffic,
                                            "sample_steps": 2},
                        cell.end_to_end, cell.per_layer)
    rows = readings.readings(cell, [11, 12], [13], "cpu", emit=lambda r: 0)
    limits = cfg["checks"]
    sides = {r["side"] for r in rows}
    assert "control:lower" in sides
    for r in rows:
        assert set(r["numbers"]) == set(limits)
        over = [k for k, v in r["numbers"].items() if not v <= limits[k]]
        if r["side"] == "program":
            assert not over, r
        else:
            assert over, r

"""Every fault a cell can have, planted in the port, and the control (the
reference in TF32 in the program's place) fail the output check."""
import pytest

from gnnbench import faults, harness, inputs, loader
from gnnbench.reference import Reference

CELLS = ["gcn-papers100m.coop", "gcn-papers100m.indep", "rgcn-mag240m.coop"]
# the number each fault must fail; the exchange exists in cooperative cells only
CAUGHT_BY = {"state_unchanged": "change_gap", "half_batch": "loss_gap",
             "no_exchange": "plan_mismatch", "grad_altered": "grad_gap"}
CASES = [(c, f) for c in CELLS for f in faults.FAULTS
         if not (f == "no_exchange" and c.endswith(".indep"))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_fails(run_tiny, cell, fault):
    with faults.planted(fault):
        out, _ = run_tiny(cell)
    assert out["correct"] is False
    c = out["checks"][CAUGHT_BY[fault]]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny, cell):
    root, bench = tiny
    c = loader.cell(cell, bench)
    cfg = loader.config(c["config"], bench)
    for seed in (1, 2, 3):
        ga, labels, train, feats, w0 = inputs.make(seed, cfg, "cpu")
        ref = Reference(ga, labels, train, cfg, c["mode"], harness.NUM_PES, c["local_batch"],
                        seed)
        numbers = faults.control_numbers(ref, lambda ids: feats[ids], w0, harness.CHECK_STEPS,
                                         cfg["optimizer"]["beta1"])
        assert any(numbers[k] > c["limits"][k] for k in numbers), numbers


def test_faults_are_removed_after_the_run():
    from repro_torch.core.cooperative import SimExecutor
    from repro_torch.train import loop

    before = (loop.adam_update, loop.masked_softmax_xent, SimExecutor.exchange)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert (loop.adam_update, loop.masked_softmax_xent, SimExecutor.exchange) == before

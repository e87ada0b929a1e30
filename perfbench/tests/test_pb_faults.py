"""A run whose timed path is broken underneath comes out not correct: the
whole run of a tiny cell on the CPU (the harness's look for a GPU skipped),
the Engine call wrapped by each fault a serving cell can have. (The cells
run on one chip: there is no exchange between chips to leave out.)"""
import pytest
import torch

from perfbench.tests import tiny


def stale(call):
    """A step that returns its state unchanged: each call answers with the
    previous call's logits (zeros the first time)."""
    last = []

    def f(x):
        out = call(x)
        prev = last[0] if last else torch.zeros_like(out)
        last[:] = [out]
        return prev
    return f


def half_batch(call):
    """Half of the batch left out: the rows of its second half never
    computed (zeros)."""
    def f(x):
        out = call(x).clone()
        out[x.shape[0] // 2:] = 0
        return out
    return f


def altered(call):
    """An answer altered where it is produced: the top logit of each call's
    first image raised by 16 output steps."""
    def f(x):
        out = call(x).clone()
        out[0, out[0].argmax()] += 16 * 0.02
        return out
    return f


BATCHED = [w for w in tiny.WORKLOADS if tiny.cell(w).traffic["batch"] > 1]
CASES = ([(w, f) for w in tiny.WORKLOADS for f in (stale, altered)]
         + [(w, half_batch) for w in BATCHED])   # a batch of one has no half


@pytest.mark.parametrize(("workload", "fault"), CASES, ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(workload, fault):
    # a tiny ResNet call takes about 0.25 s on one CPU thread: room for four calls
    out = tiny.run(workload, wrap=fault, seconds=2.0)
    assert out["attempted"] >= 4 * tiny.cell(workload).traffic["batch"]
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_sound_run_is_correct(workload):
    assert tiny.run(workload, seconds=0.3)["correct"] is True


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_control_is_not_correct(workload):
    """The control (the reference at 4-bit activations in the program's
    place) fails the cell's limits on the rows a run samples."""
    from perfbench import harness

    cell = tiny.cell(workload)
    art_dir, pool, _, _ = harness.setup(cell, 2**31 + 21, torch.device("cpu"))
    nums = harness.control(cell, 2**31 + 21, art_dir, pool, torch.device("cpu"))
    assert any(v > cell.limits[k]["limit"] for k, v in nums.items())

"""The comparison that decides ``correct``, on the CPU at a tiny size: the
program passes, a perturbed input fails, the control (the reference with
float8 operands in the program's place) fails, and a run with the timed
path broken underneath reports ``correct`` false for each fault a
training cell can have."""
import dataclasses
import json

import pytest
import torch

from bench_port import catalog, check, harness, inputs

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
SEED = 2 ** 31 + 12345  # seeds beyond 32 signed bits are valid


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _program_and_reference(name, seed=SEED):
    cfg, cell = harness.load(name, tiny=True)
    s = harness.prepare(cfg, cell, seed, "cpu")
    inp, compared = s.inp, s.compared
    s.close()
    return cfg, cell, inp, compared


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_at_a_tiny_size(name):
    cfg, cell, inp, compared = _program_and_reference(name)
    n = harness.compared_calls(cell["steps_per_call"]) * cell["steps_per_call"]
    assert len(compared.metrics) == n
    correct, shown = harness.judge(cfg, cell, inp, compared)
    assert correct, shown


@pytest.mark.parametrize("name", ["dcgan224-b128-k4", "wgan224-b64-n5"])
def test_a_perturbed_input_fails(name):
    cfg, cell, inp, compared = _program_and_reference(name)
    # the reference sees other rows than the program trained on
    other = dataclasses.replace(inp, order=inp.order.roll(1, dims=0))
    correct, _ = harness.judge(cfg, cell, other, compared)
    assert not correct
    # or other step draws
    other = dataclasses.replace(inp, draw_seed=inp.draw_seed + 1)
    correct, _ = harness.judge(cfg, cell, other, compared)
    assert not correct


@pytest.mark.parametrize("name", ["dcgan224-b128-k4", "wgan224-b64-n5"])
def test_the_control_fails(name):
    cfg, cell, inp, _ = _program_and_reference(name)
    ref = harness.reference_outputs(cfg, cell, inp)
    control = harness.reference_outputs(cfg, cell, inp, precision="fp8")
    correct, shown = check.judge(
        check.readings(control, ref, cfg),
        cell["limits"])
    assert not correct, shown


def _unchanged(step):
    """The step, with every parameter put back as it found it."""
    def broken(g, d, *args, **kw):
        saved = [p.detach().clone() for p in (*g.parameters(),
                                              *d.parameters())]
        out = step(g, d, *args, **kw)
        with torch.no_grad():
            for p, s in zip((*g.parameters(), *d.parameters()), saved):
                p.copy_(s)
        return out
    return broken


def _half_batch(step):
    """The step on the first half of its batch, its means over that half."""
    def broken(g, d, opt_g, opt_d, store_u8, idx, **kw):
        return step(g, d, opt_g, opt_d, store_u8, idx[:idx.shape[0] // 2],
                    **kw)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            capsys):
    from xgan_torch.train import gan, wgan
    module, attr = (wgan, "wgan_step") if name.startswith("wgan") \
        else (gan, "dcgan_step")
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    rc = harness.main(["--workload", name, "--seed", str(SEED),
                       "--seconds", "0.01"], 0.0, device="cpu", tiny=True)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["check"]


def test_seeds_make_the_same_inputs():
    cfg, cell = harness.load("dcgan224-b128-k4", tiny=True)
    a = inputs.make(cfg, cell, SEED, "cpu")
    b = inputs.make(cfg, cell, SEED, "cpu")
    assert torch.equal(a.store, b.store) and torch.equal(a.order, b.order)
    assert a.draw_seed == b.draw_seed
    c = inputs.make(cfg, cell, SEED + 1, "cpu")
    assert not torch.equal(a.store, c.store)
    # the first batches share no row
    k = cell["steps_per_call"]
    first = a.order[:harness.compared_calls(k) * k].reshape(-1)
    assert first.unique().numel() == first.numel()

"""``correct`` at a size the CPU holds: sound runs of each kind come out
correct; the control (the reference one precision below the
configuration's, in the program's place) and runs with the timed path
broken underneath come out not correct. The runs skip the look for a
card and drive the rest of ``run_cell``."""

import pytest
import torch

from h100bench import run
from h100bench.bench import load_cell
from tiny import CELLS, LIMIT, make_tree

SEED = 2 ** 32 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(root, name, trace):
    result, checks = run.run_cell(load_cell(root, name), SEED, 0.3, bool(trace), "cpu")
    assert result["correct"] and result["failed"] == 0
    assert 0 <= checks["max_score_gap"][0] <= LIMIT
    assert list(result)[-1] == "checks"
    short = "assay" in name
    if trace:
        assert ("pad_share.short" if short else "pad_share") in result["metrics"]
    else:
        assert result["metrics"]["assay_s_p95" if short else "mutants_per_s"]["value"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(root, name):
    """The control in the program's place, judged by the run's own decision."""
    result, checks = run.run_cell(load_cell(root, name), SEED, 0.3, False, "cpu", control=True)
    assert result["failed"] == 0
    assert not result["correct"]
    assert checks["max_score_gap"][0] > 3 * LIMIT


def _half_batch(fn):
    """Half of each forward's rows left out, the rest's mean in their place."""
    def broken(tokens, *args, **kwargs):
        keep = max(1, tokens.shape[0] // 2)
        out = fn(tokens[:keep], *args, **kwargs)
        return torch.cat([out, out.mean(0, keepdim=True).expand(tokens.shape[0] - keep,
                                                                *out.shape[1:])])
    return broken


def _altered_answer(fn):
    """Each forward's first row's logits moved where they are produced."""
    def broken(tokens, *args, **kwargs):
        out = fn(tokens, *args, **kwargs).clone()
        out[0] += torch.linspace(0.0, 2.0, out.shape[-1])
        return out
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_broken_timed_path_is_not_correct(root, name, fault, monkeypatch):
    cell = load_cell(root, name)
    build = cell.family.build

    def broken_build(*args, **kwargs):
        program = build(*args, **kwargs)
        program.logits_fn = fault(program.logits_fn)
        return program

    monkeypatch.setattr(cell.family, "build", broken_build)
    result, checks = run.run_cell(cell, SEED, 0.3, False, "cpu")
    assert not result["correct"]
    assert checks["max_score_gap"][0] > LIMIT

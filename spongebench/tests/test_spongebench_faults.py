"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path; and true for the sound program.

The control drops one partial round from the program's config.  The
faults: a permutation that returns its state unchanged; half the lanes of
every permutation left out (their states returned as they came); an answer
altered where it is produced (the root, or an opened sibling).  No cell
runs across chips, so no exchange can be left out."""

import pytest
import torch

from spongebench.harness import load_benchmark, resolve
from spongebench.tests.helpers import tiny_run

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
OPENING_CELLS = [c for c in CELLS if resolve(c).traffic.get("openings")]


def unchanged(real):
    return lambda cfg, state, backend="auto": state.clone()


def half_left_out(real):
    def permute(cfg, state, backend="auto"):
        half = state.shape[-1] // 2
        if half == 0:
            return state.clone()
        return torch.cat([real(cfg, state[..., :half].contiguous(), backend), state[..., half:]], -1)

    return permute


def _bump(plane):
    out = plane.clone()
    out.view(-1)[0] ^= 1
    return out


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    assert tiny_run(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = tiny_run(name, control=True)
    assert out["correct"] is False
    assert out["checks"]["node_mismatches"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_left_out])
@pytest.mark.parametrize("name", CELLS)
def test_broken_permutation_is_not_correct(monkeypatch, name, fault):
    from sponge_tpu_torch import hash as sthash

    monkeypatch.setattr(sthash, "batched_permute", fault(sthash.batched_permute))
    assert tiny_run(name, leaves_log2=3)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_altered_root_is_not_correct(monkeypatch, name):
    from sponge_tpu_torch import hash as sthash

    real = sthash._tree_levels

    def altered(*args):
        levels = real(*args)
        return levels[:-1] + [_bump(levels[-1])]

    monkeypatch.setattr(sthash, "_tree_levels", altered)
    out = tiny_run(name)
    assert out["correct"] is False


@pytest.mark.parametrize("name", OPENING_CELLS)
def test_altered_opening_is_not_correct(monkeypatch, name):
    from sponge_tpu_torch import hash as sthash

    real = sthash.merkle_open_batch
    monkeypatch.setattr(sthash, "merkle_open_batch", lambda levels, idx: _bump(real(levels, idx)))
    out = tiny_run(name)
    assert out["correct"] is False
    assert out["checks"]["answer_mismatches"]["value"] > 0

"""Fiat–Shamir transcripts: an absorb/squeeze schedule replayed over planes.

Counterpart of ``sponge_tpu/transcript.py:34-225``.  A transcript's structure
(how many elements each step absorbs or squeezes) is the same for every
lane, so the duplex bookkeeping (mode, rate index, where the permutations
fall) runs on the host and the device sees only a chain of batched
permutations and rate-row additions:

    run = compile_transcript(cfg, [Absorb(3), SqueezeNative(2)])
    outs = run(elems)   # (total_absorbed, L, B) -> (total_squeezed, L, B)

Outputs are canonical plain limb planes (``from_mont`` once at the end).
PyTorch runs eagerly, so "compiling" fixes the schedule and checks shapes;
there is no program to cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch

from .ops import montgomery as mont
from .poseidon.permutation import SpongeConfig, add_rows, batched_permute, zero_state


@dataclass(frozen=True)
class Absorb:
    """Absorb ``num_elements`` pre-encoded native field elements."""

    num_elements: int


@dataclass(frozen=True)
class SqueezeNative:
    """Squeeze ``num_elements`` native field elements."""

    num_elements: int


Step = Union[Absorb, SqueezeNative]


def _replay(
    cfg: SpongeConfig,
    steps: Sequence[Step],
    elems: torch.Tensor,
    backend: str,
    state=None,
    mode: str = "absorbing",
    index: int = 0,
    return_state: bool = False,
):
    """Replay the duplex state machine from ``(state, mode, index)`` (a fresh
    zero sponge by default) over the rows of ``elems``.  Returns the squeezed
    canonical plane, and the final state with ``return_state``; the final
    (mode, index) is ``segment_bookkeeping``'s."""
    L, B = elems.shape[-2], elems.shape[-1]
    if state is None:
        state = zero_state(cfg, B, elems.device)
    pos = 0
    outs = []

    def permute(st):
        return batched_permute(cfg, st, backend)

    for step in steps:
        if isinstance(step, Absorb):
            n = step.num_elements
            if n == 0:
                continue
            chunk = elems[pos : pos + n]
            pos += n
            if mode == "absorbing":
                start = index
                if start == cfg.rate:
                    state = permute(state)
                    start = 0
            else:
                state = permute(state)
                start = 0
            off = 0
            remaining = n
            while True:
                if start + remaining <= cfg.rate:
                    state = add_rows(cfg, state, start, chunk[off : off + remaining])
                    mode, index = "absorbing", start + remaining
                    break
                take = cfg.rate - start
                state = permute(add_rows(cfg, state, start, chunk[off : off + take]))
                off += take
                remaining -= take
                start = 0
        elif isinstance(step, SqueezeNative):
            n = step.num_elements
            if mode == "absorbing":
                state = permute(state)
                start = 0
            else:
                start = index
                if start == cfg.rate:
                    state = permute(state)
                    start = 0
            remaining = n
            while True:
                lo = cfg.capacity + start
                if start + remaining <= cfg.rate:
                    outs.append(state[lo : lo + remaining])
                    mode, index = "squeezing", start + remaining
                    break
                take = cfg.rate - start
                outs.append(state[lo : lo + take])
                # Reference quirk: no permute when the remaining output equals the rate.
                if remaining != cfg.rate:
                    state = permute(state)
                remaining -= take
                start = 0
        else:
            raise TypeError(f"unknown transcript step: {step!r}")

    if outs:
        squeezed = mont.from_mont(cfg.field, torch.cat(outs)).int()
    else:
        squeezed = torch.zeros((0, L, B), dtype=torch.int32, device=elems.device)
    if return_state:
        return squeezed, state
    return squeezed


def segment_bookkeeping(
    cfg: SpongeConfig, steps: Sequence[Step], mode: str, index: int
) -> Tuple[str, int]:
    """Final (mode, index) after replaying ``steps`` from (mode, index),
    without touching device values."""
    for step in steps:
        if isinstance(step, Absorb):
            if step.num_elements == 0:
                continue
            start = index if mode == "absorbing" else 0
        elif isinstance(step, SqueezeNative):
            start = index if mode == "squeezing" else 0
        else:
            raise TypeError(f"unknown transcript step: {step!r}")
        if start == cfg.rate:
            start = 0
        remaining = step.num_elements
        while start + remaining > cfg.rate:
            remaining -= cfg.rate - start
            start = 0
        mode = "absorbing" if isinstance(step, Absorb) else "squeezing"
        index = start + remaining
    return mode, index


def transcript_shape(steps: Sequence[Step]) -> Tuple[int, int]:
    """(total absorbed elements, total squeezed elements) of a schedule."""
    a = sum(s.num_elements for s in steps if isinstance(s, Absorb))
    q = sum(s.num_elements for s in steps if isinstance(s, SqueezeNative))
    return a, q


def compile_transcript(cfg: SpongeConfig, steps: Sequence[Step], backend: str = "auto"):
    """``fn(elems)``: a ``(total_absorbed, L, B)`` Montgomery element plane
    (all absorbed values in schedule order) -> ``(total_squeezed, L, B)``
    canonical output plane."""
    steps = tuple(steps)
    total_absorbed, _ = transcript_shape(steps)

    def run(elems: torch.Tensor) -> torch.Tensor:
        if elems.shape[0] != total_absorbed:
            raise ValueError(
                f"transcript input plane has {elems.shape[0]} element rows; "
                f"the schedule absorbs {total_absorbed}"
            )
        return _replay(cfg, steps, elems, backend)

    return run

"""Batched duplex Poseidon sponge over device limb planes.

Counterpart of ``sponge_tpu/sponge.py``: one instance advances ``B``
independent sponge lanes in lockstep.  The duplex bookkeeping (mode, rate
index, chunking) is host-side Python shared by all lanes; the state is a
``(t, L, B)`` int32 canonical Montgomery plane on ``device`` and every
permutation is ``batched_permute``.

Dispatch is lazy by default: absorbs queue on the host and each squeeze
replays the pending ``[Absorb..., Squeeze]`` segment (``transcript._replay``).
``lazy=False`` replays every absorb as it comes; both give identical
outputs.  ``.mode`` / ``.index`` are always live.

Planes are never written in place: ``clone()``/``fork()`` share them.

Reference quirks kept: absorb *adds* into the rate part; the squeeze loop
skips the permutation when the remaining output equals the rate;
``Truncated`` sizes never truncate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import absorb as absorb_codec
from .fields import LIMB_BITS, FieldSpec, ints_to_mont_tensor, limbs_to_ints
from .ops import montgomery as mont
from .poseidon.oracle import ABSORBING, FULL, SpongeState, field_element_size_num_bits
from .poseidon.permutation import SpongeConfig, zero_state
from .transcript import Absorb, SqueezeNative, _replay, segment_bookkeeping


@dataclass(frozen=True)
class Batched:
    """Per-lane absorb input: one codec value per lane, all of one structure."""

    lanes: Sequence


def decode_canonical_plane(fs: FieldSpec, plane: torch.Tensor) -> list:
    """(k, L, B) canonical plain plane -> lane-major ints [B][k]."""
    arr = plane.detach().cpu().numpy()
    cols = [limbs_to_ints(fs, row) for row in arr]  # [k][B]
    return [list(lane) for lane in zip(*cols)] if cols else [[] for _ in range(arr.shape[-1])]


class PoseidonSponge:
    """Batched Poseidon duplex sponge.  Squeeze outputs are lane-major:
    ``squeeze_native_field_elements(n)`` returns ``[B][n]`` ints,
    ``squeeze_bytes(n)`` ``[B]`` byte strings, and so on."""

    #: Lazy mode flushes an absorb-only segment once this many element rows
    #: are queued, which bounds host memory under long absorb streams.
    FLUSH_ROWS = 256

    def __init__(
        self,
        cfg: SpongeConfig,
        batch_size: int = 1,
        lazy: bool = True,
        backend: str = "auto",
        *,
        device,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.plane = zero_state(cfg, batch_size, self.device)
        self._pending: list = []  # queued (k, L, B) element planes
        self.mode = ABSORBING
        self.index = 0
        self._lazy = lazy
        self._backend = backend

    # ---- duplex bookkeeping (live over queued lazy absorbs) ----

    @property
    def mode(self) -> str:
        if self._pending:
            return self._virtual_bookkeeping()[0]
        return self._mode

    @mode.setter
    def mode(self, value: str):
        self._mode = value

    @property
    def index(self) -> int:
        if self._pending:
            return self._virtual_bookkeeping()[1]
        return self._index

    @index.setter
    def index(self, value: int):
        self._index = value

    def _virtual_bookkeeping(self):
        steps = tuple(Absorb(p.shape[0]) for p in self._pending)
        return segment_bookkeeping(self.cfg, steps, self._mode, self._index)

    # ---- absorb ----

    def absorb(self, x):
        """Absorb a codec value (the same for every lane) or a ``Batched``."""
        fs = self.cfg.field
        if isinstance(x, Batched):
            lanes = list(x.lanes)
            if len(lanes) != self.batch_size:
                raise ValueError("Batched input must have one value per lane")
            encoded = [absorb_codec.to_sponge_field_elements(v, fs) for v in lanes]
            if len({len(e) for e in encoded}) != 1:
                raise ValueError("Batched lanes must encode to the same number of elements")
            if not encoded[0]:
                return
            grid = [list(col) for col in zip(*encoded)]  # (k, B)
            self.absorb_element_plane(ints_to_mont_tensor(fs, grid, self.device))
            return
        elems = absorb_codec.to_sponge_field_elements(x, fs)
        if not elems:
            return
        col = ints_to_mont_tensor(fs, [[e] for e in elems], self.device)  # (k, L, 1)
        self.absorb_element_plane(col.expand(len(elems), fs.nlimbs, self.batch_size))

    def absorb_stream(self, chunks) -> int:
        """Absorb an iterable of inputs chunk by chunk, in bounded memory.
        A chunk is a pre-encoded (k, L, B) Montgomery element plane (a 3-D
        tensor) or anything ``absorb`` takes.  Returns the number of chunks."""
        n = 0
        for chunk in chunks:
            if isinstance(chunk, torch.Tensor) and chunk.dim() == 3:
                self.absorb_element_plane(chunk)
            else:
                self.absorb(chunk)
            n += 1
        return n

    def absorb_element_plane(self, elems: torch.Tensor):
        """Absorb a pre-encoded (k, L, B) canonical Montgomery element plane."""
        if elems.shape[0] == 0:
            return
        if elems.shape[-1] != self.batch_size:
            raise ValueError("element plane batch axis must match batch_size")
        self._pending.append(elems.to(self.device))
        if not self._lazy or sum(p.shape[0] for p in self._pending) >= self.FLUSH_ROWS:
            self._flush()

    # ---- dispatch ----

    def _flush(self, squeeze_n=None):
        """Replay the queued absorbs (plus a squeeze of ``squeeze_n``
        elements, which may be 0); returns the squeezed canonical plane, or
        None without a squeeze."""
        steps = tuple(Absorb(p.shape[0]) for p in self._pending)
        if squeeze_n is not None:
            steps += (SqueezeNative(squeeze_n),)
        if not steps:
            return None
        L = self.cfg.field.nlimbs
        elems = (
            torch.cat(self._pending)
            if self._pending
            else torch.zeros((0, L, self.batch_size), dtype=torch.int32, device=self.device)
        )
        end = segment_bookkeeping(self.cfg, steps, self._mode, self._index)
        out, self.plane = _replay(
            self.cfg, steps, elems, self._backend,
            state=self.plane, mode=self._mode, index=self._index, return_state=True,
        )
        self._pending = []
        self.mode, self.index = end
        return out if squeeze_n is not None else None

    # ---- squeezes ----

    def squeeze_native_plane(self, num: int) -> torch.Tensor:
        """(num, L, B) canonical plain limb plane of squeezed native elements."""
        return self._flush(num)

    def squeeze_native_field_elements(self, num: int) -> list:
        """Lane-major ints [B][num]."""
        return decode_canonical_plane(self.cfg.field, self.squeeze_native_plane(num))

    def squeeze_bytes_plane(self, num_bytes: int) -> np.ndarray:
        """(B, num_bytes) uint8: the low usable LE bytes of each element (a
        byte never straddles two 24-bit limbs)."""
        fs = self.cfg.field
        usable = (fs.modulus_bit_size - 1) // 8
        num_elements = -(-num_bytes // usable)
        plane = self.squeeze_native_plane(num_elements).cpu().numpy()  # (k, L, B)
        j = np.arange(usable)
        byts = (plane[:, 8 * j // LIMB_BITS, :] >> (8 * j % LIMB_BITS)[None, :, None]) & 0xFF
        k, _, B = byts.shape
        return byts.astype(np.uint8).transpose(2, 0, 1).reshape(B, k * usable)[:, :num_bytes]

    def squeeze_bytes(self, num_bytes: int) -> list:
        grid = self.squeeze_bytes_plane(num_bytes)
        return [grid[b].tobytes() for b in range(grid.shape[0])]

    def squeeze_bits_plane(self, num_bits: int) -> np.ndarray:
        """(B, num_bits) bool: the low usable LE bits of each element."""
        fs = self.cfg.field
        usable = fs.modulus_bit_size - 1
        num_elements = -(-num_bits // usable)
        plane = self.squeeze_native_plane(num_elements).cpu().numpy()
        i = np.arange(usable)
        bits = (plane[:, i // LIMB_BITS, :] >> (i % LIMB_BITS)[None, :, None]) & 1
        k, _, B = bits.shape
        return bits.transpose(2, 0, 1).reshape(B, k * usable)[:, :num_bits].astype(bool)

    def squeeze_bits(self, num_bits: int) -> list:
        grid = self.squeeze_bits_plane(num_bits)
        return [[bool(v) for v in grid[b]] for b in range(grid.shape[0])]

    def squeeze_field_elements_with_sizes(self, target_fs: FieldSpec, sizes) -> list:
        if self.cfg.field.modulus == target_fs.modulus:
            lanes = self.squeeze_native_field_elements_with_sizes(sizes)
            return [[v % target_fs.modulus for v in lane] for lane in lanes]
        return self._squeeze_nonnative_default(target_fs, sizes)

    def squeeze_field_elements(self, target_fs: FieldSpec, num: int) -> list:
        if self.cfg.field.modulus == target_fs.modulus:
            return self.squeeze_native_field_elements(num)
        return self.squeeze_field_elements_with_sizes(target_fs, [FULL] * num)

    def squeeze_native_field_elements_with_sizes(self, sizes) -> list:
        if all(s == FULL for s in sizes):
            return self.squeeze_native_field_elements(len(sizes))
        return self._squeeze_nonnative_default(self.cfg.field, sizes)

    def _squeeze_nonnative_default(self, target_fs: FieldSpec, sizes) -> list:
        """Bit-packing default (num_bits measured against the target field)."""
        if len(sizes) == 0:
            return [[] for _ in range(self.batch_size)]
        per = [field_element_size_num_bits(s, target_fs) for s in sizes]
        grid = self.squeeze_bits_plane(sum(per))
        out = []
        for b in range(grid.shape[0]):
            lane, pos = [], 0
            for n in per:
                packed = np.packbits(grid[b, pos : pos + n], bitorder="little").tobytes()
                lane.append(target_fs.from_le_bytes_mod_order(packed))
                pos += n
            out.append(lane)
        return out

    # ---- fork / clone / state ----

    def fork(self, domain: bytes) -> "PoseidonSponge":
        """Domain separation: clone, absorb len(domain) ‖ domain."""
        new = self.clone()
        new.absorb(
            absorb_codec.to_sponge_bytes(absorb_codec.Usize(len(domain))) + bytes(domain)
        )
        return new

    def clone(self) -> "PoseidonSponge":
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._pending = list(self._pending)  # planes are never written in place
        return new

    def into_state(self) -> SpongeState:
        """Externalize {state, mode, index} as host values."""
        self._flush()
        canonical = mont.from_mont(self.cfg.field, self.plane).int()
        lanes = decode_canonical_plane(self.cfg.field, canonical)
        return SpongeState(
            state=[list(col) for col in zip(*lanes)], mode=self.mode, index=self.index
        )

    @classmethod
    def from_state(cls, state: SpongeState, cfg: SpongeConfig, *, device) -> "PoseidonSponge":
        rows = state.state  # [t][B] ints
        new = cls(cfg, len(rows[0]), device=device)
        new.plane = ints_to_mont_tensor(cfg.field, rows, new.device)
        new.mode = state.mode
        new.index = state.index
        return new

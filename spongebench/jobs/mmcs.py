"""The MMCS job: a commitment as SP1 makes it over Plonky3 (``jobs/commit.py``
with its inputs, openings and judge), whose two calls are Plonky3's modes:

* each row of ``leaf_elems`` elements is hashed into ``digest_elems`` by
  the padding-free sponge (``hash.padding_free_hash``);
* the tree compresses two digests with one truncated permutation
  (``hash.merkle_tree_truncated``), all levels kept.

The configuration states these modes (``absorb`` "overwrite",
``compression`` "truncated"), and its family's reference computes them.
A program without the two calls fails before any input is made.

The harness keeps every commitment's host copies for the judge: here 100
paths of 23 levels of 8 elements, 147,200 bytes a commitment, a fresh host
allocation each time.  On the card's machine a fresh page faults for about
8 us, and the copies cost 1.4-1.9 ms a commitment more than reused ones,
with a jitter that spread a cell's runs over 1% (measured on an H100 host,
``PERF.md``).  A prover reuses its buffers; so the set-up warms the host
heap for ``WARM_COMMITMENTS`` commitments' copies, as it warms the device.
"""

from __future__ import annotations

import ctypes

from spongebench.jobs import commit

STATED = {"absorb": "overwrite", "compression": "truncated"}
WARM_COMMITMENTS = 4096  # three times a 50 s window's at 40 ms a commitment


class _Calls:
    """The program's hash module under the names the commit job calls:
    its leaf hash and its wide tree are Plonky3's modes."""

    def __init__(self, sthash):
        self.hash_elements = sthash.padding_free_hash
        self.merkle_tree_wide = sthash.merkle_tree_truncated
        self.merkle_open_batch = sthash.merkle_open_batch


class Job(commit.Job):
    def __init__(self, cfg, config: dict, traffic: dict, device, seed: int):
        from sponge_tpu_torch import hash as sthash

        wrong = {k: config.get(k) for k, v in STATED.items() if config.get(k) != v}
        if wrong:
            raise ValueError(f"the MMCS job runs {STATED}; the configuration states {wrong}")
        calls = _Calls(sthash)  # raises on a program without the two calls
        super().__init__(cfg, config, traffic, device, seed)
        self.hash = calls
        depth, limbs = self.n.bit_length() - 1, self.inputs[0].shape[1]
        _warm_host_heap(WARM_COMMITMENTS * depth * self.d * limbs * 4 * self.openings)


def _warm_host_heap(nbytes: int) -> None:
    """Fault ``nbytes`` of the main thread's malloc heap in and keep it:
    pieces below 32 MiB come from the heap (not a mapping of their own),
    freed memory stays in the process, and the heap is grown and touched
    once now.  Without glibc's ``mallopt`` it does nothing."""
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    mallopt(m_mmap_threshold, 32 << 20)
    mallopt(m_trim_threshold, (1 << 31) - 1)
    pieces = [bytearray(16 << 20) for _ in range(-(-nbytes // (16 << 20)))]
    del pieces

"""The port's profiling helpers (``utils/profiling.py``): ``trace`` writes
a Chrome trace holding an ``annotate`` span; ``device_busy_share`` reads
kernel time from a trace.  On the CPU a trace holds no CUDA kernel, so its
busy share is 0: the device's share is read on the card (chip_smoke.py).
The spans' records are tested in ``test_torch_spans.py``."""

import json

import pytest

import sponge_tpu_torch as st
from sponge_tpu_torch.utils import profiling as prof


def test_trace_writes_annotated_chrome_trace(tmp_path):
    cfg = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 4)
    state = st.zero_state(cfg, 8, "cpu")
    with prof.trace(tmp_path / "run"):
        with prof.annotate("permute_span"):
            st.batched_permute(cfg, state)
    path = tmp_path / "run" / prof.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "permute_span" for e in events)
    share = prof.device_busy_share(tmp_path / "run")
    assert share["window_us"] > 0
    assert (share["kernel_us"], share["busy_share"], share["kernels"]) == (0.0, 0.0, {})


def test_device_busy_share_counts_overlaps_once(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "launch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},  # overlaps a by 10
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 62, "dur": 4},  # inside the last a
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 500},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    share = prof.device_busy_share(path)
    assert share["window_us"] == 100 and share["kernel_us"] == 40
    assert share["busy_share"] == 0.4
    assert share["kernels"] == {"a": 30, "b": 24}
    path.write_text(json.dumps([]))
    with pytest.raises(ValueError, match="no timed events"):
        prof.device_busy_share(path)

"""Host-clock cost of one permutation of the plain PyTorch tier on the CPU.

    python -m sponge_tpu_torch.cpu_cost

Runs ``batched_permute`` on a CPU tensor of B = 4 lanes (the plain version
of each kernel) once per family at its default BLS12-381 Fr config, after
one warm call, and prints the seconds.  It measures the CPU tier only, never
a device.
"""

from __future__ import annotations

import time

import torch

import sponge_tpu_torch as st

B = 4


def configs():
    fr = st.BLS12_381_FR
    return {
        "Poseidon rate 2": st.get_default_poseidon_parameters(fr, 2),
        "Poseidon2 rate 2": st.get_default_poseidon2_parameters(fr, 2),
        "Rescue-Prime rate 2": st.get_default_rescue_parameters(fr, 2),
        "GMiMC rate 2": st.get_default_gmimc_parameters(fr, 2),
        "Griffin rate 2": st.get_default_griffin_parameters(fr, 2),
        "Anemoi rate 3": st.get_default_anemoi_parameters(fr, 3),
        "Anemoi rate 1": st.get_default_anemoi_parameters(fr, 1),
    }


def main() -> int:
    print(f"torch {torch.__version__}, {torch.get_num_threads()} CPU threads, B = {B}")
    for name, cfg in configs().items():
        state = st.zero_state(cfg, B, "cpu")
        st.batched_permute(cfg, state)
        t0 = time.perf_counter()
        st.batched_permute(cfg, state)
        print(f"{name} (t = {cfg.t}, {cfg.field.name}): {time.perf_counter() - t0:.2f} s per permutation")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

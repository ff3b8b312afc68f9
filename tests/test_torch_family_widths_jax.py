"""Kernel 5's Goldilocks widths against the JAX package's XLA tier.

The plain version of Rescue-Prime (``rescue_permute_plain``, kernel 5's
function) equals ``rescue_permute_jit`` at every (t, L) of the default table
compiled since the wide schedules at the small fields: here Goldilocks
t = 5..12 (L = 3), in ``tests/test_torch_family_widths_jax31.py`` the 31-bit
fields' t = 9..15 (L = 2), each on its first field, cut to one round (the
XLA tier's compile, 3-5 s here, does not depend on the round count), on 16
lanes with 0, 1, p-1 and p-2 in every element position; equality is exact.
The other new widths are held against the JAX package's oracle in
``tests/test_torch_family_widths.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_family_widths import _cut, first_of_each_pair
from test_torch_gmimc import lanes

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.rescue.permutation import rescue_permute_jit
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints


def small_widths(L):
    """{label: config}: the first default Rescue-Prime config of each new
    (t, L) at limb count L."""
    return {label: cfg for label, cfg in first_of_each_pair("rescue").items() if cfg.field.nlimbs == L}


def check_rescue_width(cfg):
    """The plain version of ``cfg`` cut to one round equals
    ``rescue_permute_jit`` of the JAX package's default config."""
    jfs = getattr(sponge_tpu, cfg.field.name.upper())
    jcfg = sponge_tpu.get_default_rescue_parameters(jfs, cfg.rate)
    assert interop.config_from_jax(jcfg) == cfg
    cfg, jcfg = _cut(cfg, 1), _cut(jcfg, 1)
    vals = lanes(jfs.modulus, cfg.t, 16, 67 + cfg.t)
    x = jnp.asarray(np.stack([jfs.ints_to_mont_plane(r) for r in vals]))
    want = [jfs.mont_plane_to_ints(r) for r in np.asarray(rescue_permute_jit(jcfg)(x))]
    out = st.RescuePermutation.plain(cfg, st.RescuePermutation(cfg, "cpu").consts,
                                     ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert mont_tensor_to_ints(cfg.field, out) == want


GOLDILOCKS = small_widths(3)


@pytest.mark.parametrize("label", list(GOLDILOCKS))
def test_rescue_plain_matches_permute_jit_at_goldilocks(label):
    check_rescue_width(GOLDILOCKS[label])

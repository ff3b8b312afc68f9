"""The JAX package's sharded Merkle roots on ``make_mesh(4)`` (narrow, with
2 leaves per device, wide and Jive) against the port's unsharded roots on
the same planes (``test_torch_parallel.planes``), which
``test_torch_parallel.py`` holds the port's four-process gloo group to.
Equality is exact on canonical values.
"""

import numpy as np
import pytest
from test_torch_parallel import FS, JCFG, JCFG4, planes, unsharded
from test_torch_parallel_jax import canon, port_canon

import sponge_tpu.parallel as jpar


@pytest.fixture(scope="module")
def both():
    p = planes()
    mesh = jpar.make_mesh(4)
    jax = dict(
        root=jpar.sharded_merkle_root(JCFG, p["leaves"][0], mesh),
        edge_root=jpar.sharded_merkle_root(JCFG, p["edge"][0], mesh),
        wide_root=jpar.sharded_merkle_root_wide(JCFG, p["wide"][0], mesh),
        jive_root=jpar.sharded_merkle_root_jive(JCFG4, p["jive"][0], mesh),
    )
    return jax, unsharded(p)


@pytest.mark.parametrize("key", ["root", "edge_root", "wide_root", "jive_root"],
                         ids=["narrow", "two_leaves_per_device", "wide", "jive"])
def test_jax_sharded_root_equals_port(both, key):
    jax, port = both
    got = port_canon(port[key].reshape(-1, FS.nlimbs, 1))
    assert got == canon(np.asarray(jax[key]).reshape(-1, JCFG.field.nlimbs, 1))

"""The JAX package's sharded permutation, transcript and verification on
``make_mesh(4)`` (the conftest's eight virtual CPU devices) against the
port's unsharded functions on the same planes
(``test_torch_parallel.planes``); the roots are in
``test_torch_parallel_jax_roots.py``.  ``test_torch_parallel.py``
holds the port's four-process gloo group to those same unsharded results,
so together the two files hold the port's sharded layer to the JAX
package's.  Equality is exact on canonical values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_parallel import FS, IDX, JCFG, P, STEPS, planes, unsharded

import sponge_tpu.parallel as jpar
import sponge_tpu.transcript as jtr
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import limbs_to_ints, mont_tensor_to_ints

JAX_STEPS = tuple(
    jtr.Absorb(s.num_elements) if type(s).__name__ == "Absorb" else jtr.SqueezeNative(s.num_elements)
    for s in STEPS
)


def canon(jplane, mont=True):
    """A JAX (k, L, B) plane as canonical ints: Montgomery, or plain (a
    transcript's output)."""
    arr = np.asarray(jplane)
    if mont:
        return interop.jax_limbs_to_ints(arr, P, JCFG.field.limb_bits).tolist()
    bits = JCFG.field.limb_bits
    return [[sum(int(x) << (bits * k) for k, x in enumerate(col)) for col in row.T] for row in arr]


def port_canon(plane, mont=True):
    """The port's (k, L, B) plane as canonical ints."""
    return [mont_tensor_to_ints(FS, p) if mont else limbs_to_ints(FS, p.numpy()) for p in plane]


def to_jax(plane):
    return jnp.asarray(interop.plane_to_jax(plane, FS, JCFG.field.limb_bits, JCFG.field.nlimbs))


@pytest.fixture(scope="module")
def both():
    p = planes()
    mesh = jpar.make_mesh(4)
    jax = dict(
        permute=jpar.sharded_permute_fn(JCFG, mesh)(p["state"][0]),
        transcript=jpar.sharded_transcript_fn(JCFG, JAX_STEPS, mesh)(p["elems"][0]),
        verify=jpar.sharded_merkle_verify_batch(
            JCFG, to_jax(p["root"][:, None])[:, 0], to_jax(p["proof_leaves"]), to_jax(p["paths"]), IDX.numpy(),
            mesh),
    )
    return jax, unsharded(p)


def test_jax_sharded_permute_equals_port(both):
    jax, port = both
    assert port_canon(port["permute"]) == canon(jax["permute"])


def test_jax_sharded_transcript_equals_port(both):
    """Transcript outputs are plain (not Montgomery) canonical planes."""
    jax, port = both
    assert port_canon(port["transcript"], mont=False) == canon(jax["transcript"], mont=False)


def test_jax_sharded_verify_equals_port(both):
    jax, port = both
    assert np.asarray(jax["verify"]).tolist() == port["verify"].tolist()

"""The port's DUF (basicsr4rs_torch/archs/duf_arch.py: 3-D convolutions,
BatchNorm3d, the dynamic upsampling filter; no Pallas kernel) against the
JAX package at 16 and 52 layers, in eval mode, as ``test_torch_tof.py``
holds TOFlow: same inputs, parameters and statistics, the same tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import duf_arch as port_duf
from basicsr4rs_tpu.archs import duf_arch as ref_duf

from test_torch_basicvsr import few_threads  # noqa: F401 (autouse fixture)
from test_torch_basicvsrpp import from_jax, to_jax
from test_torch_tof import check_forward_and_gradients, check_round_trip, jax_run

HERE = ('DUF-16', 'DUF-52')


@pytest.fixture(scope='module')
def runs():
    return {name: jax_run(name) for name in HERE}


@pytest.mark.parametrize('name', HERE)
def test_forward_and_gradients_match_jax(name, runs):
    check_forward_and_gradients(name, runs[name])


def test_weights_round_trip_through_both_converters(runs):
    check_round_trip('DUF-16', runs['DUF-16'])


def test_duf_rejects_other_depths():
    with pytest.raises(ValueError, match='16, 28, 52'):
        port_duf.DUF(num_layer=20)


def test_dynamic_upsampling_filter_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 3, 6, 7).astype(np.float32)
    filters = rng.rand(2, 25, 4, 6, 7).astype(np.float32)
    want = ref_duf.dynamic_upsampling_filter(
        to_jax(x), jnp.asarray(filters.transpose(0, 3, 4, 1, 2)), (5, 5))
    got = port_duf.dynamic_upsampling_filter(torch.from_numpy(x), torch.from_numpy(filters))
    np.testing.assert_allclose(got.numpy(), from_jax(want), rtol=1e-5, atol=1e-6)

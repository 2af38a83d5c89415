"""IconVSR at ``temporal_padding`` 2 on a clip padded in space (64x66 ->
64x68) against the JAX package: its value and every parameter's gradient on
the JAX package's plain deformable route, and its forward under
``dispatch.force_interpret()`` (PCD's deformable convolutions and the flow
warps on the Pallas kernels' own math); the keyframe groups. The helpers
and tolerances are ``test_torch_basicvsr.py``'s (a file of its own so that
the two share the test workers)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import basicvsr_arch as port
from basicsr4rs_tpu.ops import dispatch

from test_torch_basicvsr import few_threads  # noqa: F401 (autouse fixture)
from test_torch_basicvsr import (CASES, case_inputs, check_forward_and_gradients, check_round_trip,
                                 jax_run, port_network)
from test_torch_basicvsrpp import from_jax, to_jax

NAME = 'IconVSR-tp2'


@pytest.fixture(scope='module')
def run():
    """The case's inputs (clip, target, JAX params), and its ``jax_run``
    started in a thread."""
    inputs = case_inputs(NAME)
    with ThreadPoolExecutor(1) as pool:
        yield inputs, pool.submit(jax_run, NAME, *inputs)


@pytest.fixture(scope='module')
def inputs(run):
    return run[0]


@pytest.fixture(scope='module')
def interpreted(inputs):
    """The JAX network's forward with its Pallas kernels in interpret mode."""
    jax_cls, _, cfg = CASES[NAME][:3]
    jnet = jax_cls(**cfg)
    with dispatch.force_interpret():
        out = jax.jit(lambda p, a: jnet.apply({'params': p}, a))(inputs[2], to_jax(inputs[0]))
    return from_jax(out)


def test_forward_and_gradients_match_jax(run):
    check_forward_and_gradients(NAME, *run)


def test_forward_matches_the_jax_pallas_kernels(inputs, interpreted):
    net = port_network(NAME, inputs[2]).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(inputs[0])).numpy()
    np.testing.assert_allclose(got, interpreted, rtol=0, atol=1e-4 * np.abs(interpreted).max())


def test_weights_round_trip_through_both_converters(inputs):
    check_round_trip(NAME, inputs[2])


def test_keyframe_groups_give_the_same_features(inputs, monkeypatch):
    """The extractor's keyframe windows in groups of one and all at once."""
    net = port_network(NAME, inputs[2]).eval()
    clip = torch.from_numpy(inputs[0])
    with torch.no_grad():
        monkeypatch.setattr(port, 'KEYFRAME_GROUP_PIXELS', 1)
        assert [len(g) for g in port.keyframe_groups(1, 5, 64, 68, 2, 2)] == [1, 1, 1]
        one_by_one = net(clip)
        monkeypatch.setattr(port, 'KEYFRAME_GROUP_PIXELS', 1 << 30)
        assert [len(g) for g in port.keyframe_groups(1, 5, 64, 68, 2, 2)] == [3]
        together = net(clip)
    np.testing.assert_allclose(one_by_one.numpy(), together.numpy(), rtol=0, atol=1e-5)

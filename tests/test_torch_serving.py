"""The port's ahead-of-time serving (basicsr4rs_torch/utils/serving.py)
against the JAX package's (basicsr4rs_tpu/utils/serving.py) on MSRResNet x4
with one set of weights, the JAX parameters converted into the port: the six
cases of ``tests/test_utils/test_serving.py`` in both packages, outputs
within atol 1e-5 / rtol 1e-5 of the JAX ``ServingModel``'s and the same
errors raised; and a loaded artifact against the live port, bit for bit.
Float32 (and bfloat16 for the port alone) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.ops import quant as port_quant
from basicsr4rs_torch.utils import serving as port_serving
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict, jax_path_to_torch_key
from basicsr4rs_tpu.archs.srresnet_arch import MSRResNet as JaxMSRResNet
from basicsr4rs_tpu.ops import quant as jax_quant
from basicsr4rs_tpu.utils import serving as jax_serving

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Several test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(num_feat, seed=0):
    """(JAX net, JAX params, port net in eval) of one MSRResNet x4 with one
    block, the biases moved off their zero init."""
    opt = dict(num_in_ch=3, num_out_ch=3, num_feat=num_feat, num_block=1, upscale=4)
    jnet = JaxMSRResNet(**opt)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))['params']
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + (0.02 * rng.randn(*v.shape) if v.ndim == 1 else 0))
        .astype(np.float32), jax.device_get(params))
    net = MSRResNet(**opt).eval()
    net.load_state_dict(jax_params_to_state_dict(params, MSRResNet.JAX_KEY_RULES), strict=True)
    return jnet, params, net


@pytest.fixture(scope='module')
def small():
    return _pair(8)


def _save_both(tmp_path, small, buckets, batch=1, pad_multiple=1):
    """The two serving directories of one network: (JAX ServingModel, port
    ServingModel)."""
    jnet, params, net = small
    kwargs = dict(scale=4, in_chans=3, batch=batch, pad_multiple=pad_multiple,
                  meta={'network': 'MSRResNet'})
    jax_serving.save_serving_dir(str(tmp_path / 'jax'), jnet, params, buckets, **kwargs)
    port_serving.save_serving_dir(str(tmp_path / 'port'), net, buckets, device='cpu', **kwargs)
    return (jax_serving.ServingModel(str(tmp_path / 'jax')),
            port_serving.ServingModel(str(tmp_path / 'port'), device='cpu'))


def _nhwc(x):
    return x.transpose(0, 2, 3, 1) if x.ndim == 4 else x.transpose(1, 2, 0)


def test_bucket_exact_matches_jax_and_the_live_port(tmp_path, small):
    """A 16x16 request on the 16x16 bucket: the JAX ServingModel's output to
    1e-5, the live port's bit for bit."""
    jsm, psm = _save_both(tmp_path, small, [(16, 16)])
    x = np.random.RandomState(0).rand(1, 3, 16, 16).astype(np.float32)
    got = psm.run(x)
    assert got.shape == (1, 3, 64, 64) and got.device.type == 'cpu'
    np.testing.assert_allclose(got.numpy(), jsm.run(_nhwc(x)).transpose(0, 3, 1, 2), **TOL)
    with torch.no_grad():
        assert torch.equal(got, small[2](torch.from_numpy(x)))


def test_offbucket_pad_and_crop_match_jax(tmp_path, small):
    """An 11x13 request lands in the 16x16 bucket, reflect-padded and
    cropped to 44x52, as the live port on the same padded input (bit for
    bit) and the JAX ServingModel (1e-5); a 17x17 CHW request goes to the
    32x32 bucket and comes back NCHW."""
    jsm, psm = _save_both(tmp_path, small, [(32, 32), (16, 16)])
    assert psm.buckets == jsm.buckets == [(16, 16), (32, 32)]
    x = np.random.RandomState(1).rand(1, 3, 11, 13).astype(np.float32)
    got = psm.run(x)
    assert got.shape == (1, 3, 44, 52)
    np.testing.assert_allclose(got.numpy(), jsm.run(_nhwc(x)).transpose(0, 3, 1, 2), **TOL)
    xp = F.pad(torch.from_numpy(x), (0, 3, 0, 5), mode='reflect')
    with torch.no_grad():
        assert torch.equal(got, small[2](xp)[:, :, :44, :52])
    x2 = np.random.RandomState(2).rand(3, 17, 17).astype(np.float32)
    got2 = psm.run(torch.from_numpy(x2))
    assert got2.shape == (1, 3, 68, 68)
    np.testing.assert_allclose(got2.numpy(), jsm.run(_nhwc(x2)).transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize('shape, match', [
    ((1, 3, 40, 40), 'no bucket fits'),       # past every bucket
    ((1, 4, 16, 16), 'channels'),
    ((2, 3, 16, 16), 'batch'),                # above the exported batch of 1
    ((1, 3, 8, 8), 'reflect limits'),         # a pad as large as the input
])
def test_refusals_match_jax(tmp_path, small, shape, match):
    """Each request the JAX ServingModel refuses, the port's refuses with
    the same error, and runs nothing."""
    jsm, psm = _save_both(tmp_path, small, [(16, 16)])
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jsm.run(_nhwc(x))
    with pytest.raises(ValueError, match=match):
        psm.run(x)


def test_pad_multiple_is_checked_as_in_jax(tmp_path, small):
    """A bucket that is not a multiple of ``pad_multiple`` raises in both
    packages before anything is exported."""
    jnet, params, net = small
    with pytest.raises(ValueError, match='multiple'):
        jax_serving.save_serving_dir(str(tmp_path / 'jax'), jnet, params, [(15, 16)],
                                     scale=4, pad_multiple=8)
    with pytest.raises(ValueError, match='multiple'):
        port_serving.save_serving_dir(str(tmp_path / 'port'), net, [(15, 16)], scale=4,
                                      pad_multiple=8, device='cpu')
    assert not list((tmp_path / 'port').iterdir())


def test_batch_padding_matches_jax(tmp_path, small):
    """Exported at batch 4, a batch-2 request is zero-padded on the batch
    axis and cropped back: the live port's bits, the JAX output to 1e-5; a
    batch of 5 raises in both."""
    jsm, psm = _save_both(tmp_path, small, [(16, 16)], batch=4)
    x = np.random.RandomState(3).rand(2, 3, 16, 16).astype(np.float32)
    got = psm.run(x)
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), jsm.run(_nhwc(x)).transpose(0, 3, 1, 2), **TOL)
    with torch.no_grad():
        assert torch.equal(got, small[2](torch.from_numpy(x)))
    for sm, big in ((jsm, np.zeros((5, 16, 16, 3), np.float32)),
                    (psm, np.zeros((5, 3, 16, 16), np.float32))):
        with pytest.raises(ValueError, match='batch'):
            sm.run(big)


def test_int8_static_round_trip_matches_jax(tmp_path):
    """``--int8``: static scales calibrated by the JAX package on one batch,
    handed to both exporters under the port's module names (the port's own
    calibration finds the same sites and the same absmax to 1e-6); the port's
    artifact against the JAX one to 1e-5, against the live port under
    ``quantized_inference(net, act_scales=...)`` bit for bit, and away from
    the float output (the mode is on)."""
    jnet, params, net = _pair(16)
    x = np.random.RandomState(1).rand(1, 3, 16, 16).astype(np.float32)
    jscales = jax_quant.calibrate_act_scales(
        lambda b: jnet.apply({'params': params}, b), [jnp.asarray(_nhwc(x))])
    scales = {jax_path_to_torch_key(path + ('kernel',))[:-len('.weight')]: v
              for path, v in jscales.items()}
    with torch.no_grad():
        own = port_quant.calibrate_act_scales(net, net, [torch.from_numpy(x)])
    assert sorted(own) == sorted(scales)
    for name, v in own.items():
        assert v == pytest.approx(scales[name], rel=1e-6)
    jax_manifest = jax_serving.save_serving_dir(str(tmp_path / 'jax'), jnet, params, [(16, 16)],
                                                scale=4, in_chans=3, quant_act_scales=jscales)
    manifest = port_serving.save_serving_dir(str(tmp_path / 'port'), net, [(16, 16)], scale=4,
                                             in_chans=3, quant_act_scales=scales, device='cpu')
    assert manifest['quant'] == jax_manifest['quant'] == 'int8-static'
    got = port_serving.ServingModel(str(tmp_path / 'port'), device='cpu').run(x)
    want = jax_serving.ServingModel(str(tmp_path / 'jax')).run(_nhwc(x))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), **TOL)
    with torch.no_grad():
        with port_quant.quantized_inference(net, act_scales=scales):
            live = net(torch.from_numpy(x))
        fp = net(torch.from_numpy(x))
    assert torch.equal(got, live)
    assert not torch.equal(got, fp)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_artifact_equals_the_live_port(tmp_path, small, dtype):
    """A loaded artifact of each dtype gives the live network's bits at that
    dtype on a bucket-exact batch of 2, and the caller's network is left in
    float32."""
    net = small[2]
    manifest = port_serving.save_serving_dir(str(tmp_path), net, [(16, 24)], scale=4,
                                             batch=2, dtype=dtype, device='cpu')
    assert manifest['dtype'] == str(dtype)[6:]
    assert next(net.parameters()).dtype == torch.float32
    x = torch.rand(2, 3, 16, 24, generator=torch.Generator().manual_seed(4))
    got = port_serving.ServingModel(str(tmp_path), device='cpu').run(x)
    with torch.no_grad():
        live = net.to(dtype)(x.to(dtype))
    net.float()
    assert got.dtype == dtype and torch.equal(got, live)


def test_manifest_has_the_jax_keys_and_the_device(tmp_path, small):
    """The JAX manifest's keys, plus ``device``; buckets sorted by area, one
    ``net_{H}x{W}_b{B}.pt2`` each."""
    jnet, params, net = small
    want = jax_serving.save_serving_dir(str(tmp_path / 'jax'), jnet, params,
                                        [(32, 16), (16, 16)], scale=4)
    got = port_serving.save_serving_dir(str(tmp_path / 'port'), net, [(32, 16), (16, 16)],
                                        scale=4, device='cpu')
    assert set(got) == set(want) | {'device'} and got['device'] == 'cpu'
    assert [(e['h'], e['w'], e['file']) for e in got['buckets']] == [
        (16, 16, 'net_16x16_b1.pt2'), (32, 16, 'net_32x16_b1.pt2')]
    assert sorted(p.name for p in (tmp_path / 'port').iterdir()) == [
        'manifest.json', 'net_16x16_b1.pt2', 'net_32x16_b1.pt2']
    for key in ('scale', 'in_chans', 'dtype', 'pad_multiple', 'quant', 'meta'):
        assert got[key] == want[key], key


def test_default_device_is_the_card(tmp_path, small):
    """With no device both entry points ask for the card and raise on a host
    without one; a directory is served only on the device it was exported
    on."""
    net = small[2]
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_serving.export_network(net, 1, 16, 16)
    port_serving.save_serving_dir(str(tmp_path), net, [(16, 16)], scale=4, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_serving.ServingModel(str(tmp_path))
    with pytest.raises(ValueError, match='exported on cpu'):
        port_serving.ServingModel(str(tmp_path), device='meta')

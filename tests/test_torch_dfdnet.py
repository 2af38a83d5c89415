"""The port's DFDNet (basicsr4rs_torch/archs/dfdnet_arch.py, dfdnet_util.py)
and its inference script (inference/inference_dfdnet.py) against the JAX
package's, on the CPU: one 512x512 face through the VGG19 features, the
part swap against a random component dictionary of the JAX test's shapes
(``{256: (128, 9), 128: (256, 7), 64: (512, 5), 32: (512, 3)}``, three
entries a part), the MSDilation block and the SFT decoder at 64 features
(its one width).
The JAX network's parameters (kernels at He scale, the rest N(0, 0.3^2))
go to the port through ``jax_convert`` and ``DFDNet.JAX_KEY_RULES``.

Tolerances, float32: the blocks' outputs 1e-5 of their largest magnitude;
the face 1e-4 of its largest (a VGG19 of 16 convolutions at 512x512 and
the swap's AdaIN in front of the decoder).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import dfdnet_arch
from basicsr4rs_torch.archs.dfdnet_arch import DFDNet, load_dfdnet_dict, select_entry
from basicsr4rs_torch.archs.dfdnet_util import (MSDilationBlock, adaptive_instance_normalization,
                                                blur)
from basicsr4rs_torch.inference import inference_dfdnet
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import dfdnet_arch as jax_arch
from basicsr4rs_tpu.archs import dfdnet_util as jax_util

SIZES = {256: (128, 9), 128: (256, 7), 64: (512, 5), 32: (512, 3)}
PARTS = ('left_eye', 'right_eye', 'nose', 'mouth')
BOXES = np.array([[120., 150., 200., 230.], [300., 150., 380., 230.],
                  [220., 240., 290., 320.], [200., 340., 310., 420.]])


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2), order='C'))


def nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def randomized(params, seed):
    rng = np.random.RandomState(seed)

    def draw(path, a):
        if getattr(path[-1], 'key', '') == 'kernel':
            return (rng.randn(*a.shape) * (2 / np.prod(a.shape[:-1]))**0.5).astype(np.float32)
        return (rng.randn(*a.shape) * 0.3).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


def write_dict(path, seed=0):
    """A random component dictionary, as the JAX package's test makes it."""
    g = torch.Generator().manual_seed(seed)
    torch.save({f'{size}': {p: torch.randn(3, ch, k, k, generator=g) for p in PARTS}
                for size, (ch, k) in SIZES.items()}, path)
    return str(path)


def assert_close(got, want, tol, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f'{what}: {err:.3e}'


def test_blocks_match_jax():
    """The blur, AdaIN (unbiased variance) and a dilated MSDilation block."""
    rng = np.random.RandomState(1)
    x, y = rng.randn(2, 9, 11, 8).astype(np.float32), rng.randn(2, 5, 4, 8).astype(np.float32)
    assert_close(nhwc(blur(nchw(x))), jax_util.blur(jnp.asarray(x)), 1e-6, 'blur')
    assert_close(nhwc(adaptive_instance_normalization(nchw(x), nchw(y))),
                 jax_util.adaptive_instance_normalization(jnp.asarray(x), jnp.asarray(y)), 1e-5,
                 'adain')
    net = jax_util.MSDilationBlock(8, dilation=(4, 3, 2, 1))
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), x)['params'], 2)
    port = MSDilationBlock(8, dilation=(4, 3, 2, 1))
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        assert_close(nhwc(port(nchw(x))), net.apply({'params': params}, x), 1e-5, 'msdilation')


@pytest.fixture(scope='module')
def dfdnet(tmp_path_factory):
    """The JAX network (randomised) and the port holding its parameters, a
    face on 8-bit levels (so that its PNG reads back the same), the
    dictionary file, and the port's restored face."""
    tmp = tmp_path_factory.mktemp('dfdnet')
    net = jax_arch.DFDNet(num_feat=64)
    levels = np.random.RandomState(0).randint(0, 256, (1, 512, 512, 3)).astype(np.uint8)
    face = levels.astype(np.float32) / 255. * 2 - 1
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), face)['params'], 3)
    port = DFDNet(num_feat=64)
    port.load_state_dict(jax_params_to_state_dict(params, DFDNet.JAX_KEY_RULES), strict=True)
    dict_path = write_dict(tmp / 'dict.pth')
    seen = []

    def spy(part, entries):
        seen.append((part.numpy().astype(np.float64), entries.numpy().astype(np.float64)))
        return select_entry(part, entries)

    with torch.no_grad(), mock.patch.object(dfdnet_arch, 'select_entry', spy):
        out = port.eval()(nchw(face), [BOXES[i:i + 1] for i in range(4)],
                          load_dfdnet_dict(dict_path))
    return net, params, port, levels, face, dict_path, out, tmp, seen


def test_dfdnet_matches_jax(dfdnet):
    """The whole face with the four parts swapped at each of the four
    levels (16 selections), at DFDNet's one width (64 features: its
    MSDilation block runs on VGG19's 512 channels of conv5_4): each
    selection against the plain formula in float64, the face against the
    JAX package's with those selections."""
    net, params, port, _, face, dict_path, got, _, seen = dfdnet
    selected = [int(i) for i in port.selected]
    # each entry the argmax of the plain dot products, summed in float64
    assert len(selected) == 16
    assert selected == [int(np.argmax(np.einsum('chw,nchw->n', part, entries)))
                        for part, entries in seen]
    # the JAX network, handed the same selections (its float32 sums of
    # 10^5 can tie below their rounding); with them known, its forward
    # compiles as one program
    picks = iter(selected)
    dictionary = jax_arch.load_dfdnet_dict(dict_path)
    with mock.patch.object(jax_arch.jnp, 'argmax', lambda *args, **kwargs: next(picks)):
        want = jax.jit(lambda p, x: net.apply({'params': p}, x, [BOXES[i:i + 1] for i in range(4)],
                                              dictionary))(params, face)
    assert_close(nhwc(got), want, 1e-4, 'face')


def test_inference_script_matches_the_network(dfdnet):
    """``inference_dfdnet`` on the CPU: the face file and its boxes as the
    JAX package's script reads them; the network's output as an 8-bit
    image."""
    import cv2
    _, _, port, levels, _, dict_path, out, tmp, _ = dfdnet
    (tmp / 'in').mkdir()
    cv2.imwrite(str(tmp / 'in' / 'a.png'), levels[0, ..., ::-1])
    (tmp / 'boxes.txt').write_text('a.png ' + ' '.join(f'{v:g}' for v in BOXES.ravel()) + '\n')
    torch.save({'params': port.state_dict()}, tmp / 'net.pth')
    inference_dfdnet.main(['--model_path', str(tmp / 'net.pth'), '--dict_path', dict_path,
                           '--input', str(tmp / 'in'), '--locations', str(tmp / 'boxes.txt'),
                           '--output', str(tmp / 'out'), '--device', 'cpu'])
    want = ((out[0].clamp(-1, 1) + 1) / 2).permute(1, 2, 0).numpy()[..., ::-1]
    got = cv2.imread(str(tmp / 'out' / 'a.png'))
    assert np.abs(got.astype(np.float32) - (want * 255).round()).max() <= 1

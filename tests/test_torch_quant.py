"""The port's W8A8 inference (basicsr4rs_torch/ops/quant.py, the int8 joint
Swin block of ops/swin_block.py, ``val.quant_int8`` of SRModel) against the
JAX package's, on the same numpy inputs. Float32 on the CPU, where the int8
block runs its plain version and the integer convolution runs in float64.

Two float32 pipelines that agree to an ulp can still round a value that
sits on a half to different integers, so integer tensors are compared as
"equal up to a stated share of one-step flips" and outputs by SNR."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from basicsr4rs_torch.archs import swinir_arch as port_swinir
from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.ops import quant as port
from basicsr4rs_torch.ops import swin_block as port_block
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_swinir
from basicsr4rs_tpu.archs.srresnet_arch import MSRResNet as JaxMSRResNet
from basicsr4rs_tpu.ops import quant as jax_quant
from basicsr4rs_tpu.ops import swin_block as jax_block
from basicsr4rs_tpu.ops.dispatch import force_interpret

from test_torch_swin_block import HEADS, SCALE, _case, _jax_args, _port_args, bound_types


def snr_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10((ref**2).mean() / (((got - ref)**2).mean() + 1e-30))


def assert_same_integers(got, want, share=1e-3):
    """Equal but for at most ``share`` of the entries, each off by one step."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= share


def test_weight_quantisation_matches_jax():
    """Per-output-channel absmax / 127: the same scales (1e-7 relative) and
    the same integers up to 0.1% one-step flips."""
    w = np.random.RandomState(0).randn(24, 16, 3, 3).astype(np.float32)
    wq, s = port.quantize_weight_int8(torch.from_numpy(w), (1, 2, 3))
    jq, js = jax_quant.quantize_weight_int8(jnp.asarray(w.transpose(2, 3, 1, 0)), (0, 1, 2))
    assert wq.dtype == torch.int8 and s.shape == (24, 1, 1, 1)
    np.testing.assert_allclose(s.reshape(-1).numpy(), np.asarray(js), rtol=1e-7)
    assert_same_integers(wq.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    assert wq.abs().amax(dim=(1, 2, 3)).eq(127).all()   # every channel uses the full range


@pytest.mark.parametrize('static', [None, 0.03, 'halves'], ids=['dynamic', 'static', 'halves'])
def test_activation_quantisation_matches_jax(static):
    """'halves': activations of absmax 127 at k + 0.5, so that the scale is
    exactly 1 and every value lies on a half. The integers must be
    ``jnp.round``'s, half to even, with no flip allowed: for the per-tensor
    quantiser and for the per-window one of the int8 Swin block's plain
    version (the rounding only; the window scale is the port's own)."""
    if static == 'halves':
        x = (np.random.RandomState(2).randint(-127, 127, (2, 8, 8, 12)) + .5).astype(np.float32)
        x[..., 0] = 127.   # the absmax of every window and of the tensor
        want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x)), -127, 127))
        assert (want[x % 1 == .5] % 2 == 0).all()   # jnp.round: half to even
        xq, s = port.quantize_act_int8(torch.from_numpy(x))
        jq, js = jax_quant.quantize_act_int8(jnp.asarray(x), None)
        assert float(s) == float(js) == 1.
        np.testing.assert_array_equal(xq.numpy(), want)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        q, s, r = port_block._quantize_windows(torch.from_numpy(x), 4)
        assert (s == 1.).all() and torch.equal(r.reshape(x.shape), torch.from_numpy(x))
        np.testing.assert_array_equal(q.reshape(x.shape).numpy(), want)
        return
    x = np.random.RandomState(1).randn(2, 8, 12, 12).astype(np.float32)
    xq, s = port.quantize_act_int8(torch.from_numpy(x), static)
    jq, js = jax_quant.quantize_act_int8(jnp.asarray(x), static)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    assert_same_integers(xq.numpy(), np.asarray(jq))
    assert int(xq.abs().max()) == 127       # the absmax, or the clip under a small static scale


@pytest.mark.parametrize('stride, padding', [((1, 1), (1, 1)), ((2, 2), (1, 1)), ((1, 1), (0, 0))])
def test_int8_conv2d_matches_jax(stride, padding):
    """The W8A8 convolution against the JAX one (NHWC / HWIO): the integer
    sums are exact in both, so outputs differ only where an activation
    flipped by one step; SNR above 60 dB."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 12, 14).astype(np.float32)
    w = (rng.randn(24, 16, 3, 3) / 12).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    got = port.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                           stride, padding)
    want = jax_quant.int8_conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b), stride,
                                 [(p, p) for p in padding])
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert snr_db(want, got.numpy()) > 60
    ref = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), stride, padding)
    assert snr_db(ref.numpy(), got.numpy()) > 30    # and it is a convolution


def test_integer_accumulation_is_exact_at_180_channels():
    """9 * 180 * 127^2 = 26,128,980 is past float32's 2^24: with one weight
    at 126 the sum is odd there, which float32 cannot hold. Both routes (the
    CPU's float64 and the card's im2col + integer GEMM, run here on the CPU)
    give it exactly."""
    xq = torch.full((1, 180, 5, 5), 127, dtype=torch.int8)
    wq = torch.full((8, 180, 3, 3), 127, dtype=torch.int8)
    wq[3, 7, 1, 1] = 126
    wq[5] = -127
    want = 9 * 180 * 127 * 127
    assert want > 2**24
    for route in (port.int_conv2d, port.int_conv2d_gemm):
        acc = route(xq, wq, (1, 1), (1, 1))
        assert acc.dtype == torch.int32 and acc.shape == (1, 8, 5, 5)
        assert int(acc[0, 0, 2, 2]) == want
        assert int(acc[0, 3, 2, 2]) == want - 127
        assert int(acc[0, 5, 2, 2]) == -want
        assert int(acc[0, 0, 0, 0]) == 4 * 180 * 127 * 127     # a corner sees four taps


@pytest.mark.parametrize('stride, padding', [((1, 1), (1, 1)), ((2, 1), (0, 1))])
def test_both_integer_routes_agree(stride, padding):
    rng = np.random.RandomState(3)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 20, 9, 11)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (12, 20, 3, 3)).astype(np.int8))
    assert torch.equal(port.int_conv2d(xq, wq, stride, padding),
                       port.int_conv2d_gemm(xq, wq, stride, padding))


@pytest.mark.parametrize('module, eligible', [
    (nn.Conv2d(16, 32, 3, 1, 1), True),
    (nn.Conv2d(16, 32, 1), True),
    (nn.Conv2d(16, 32, 3, 2, 1), True),
    (nn.Conv2d(16, 32, 3, padding='same'), True),
    (nn.Conv2d(3, 32, 3, 1, 1), False),                    # from RGB
    (nn.Conv2d(32, 3, 3, 1, 1), False),                    # to RGB
    (nn.Conv2d(16, 32, 3, 1, 1, groups=4), False),
    (nn.Conv2d(16, 32, 3, 1, 2, dilation=2), False),
    (nn.Conv2d(16, 32, 3, 1, 1, padding_mode='reflect'), False),
    (nn.Conv2d(16, 32, 3, 1, 1, padding_mode='circular'), False),
    (nn.ConvTranspose2d(16, 32, 3), False),
    (nn.Conv3d(16, 32, 3), False),
    (nn.Conv1d(16, 32, 3), False),
    (nn.Linear(16, 32), False),
], ids=lambda v: v if isinstance(v, bool) else type(v).__name__)
def test_eligibility(module, eligible):
    assert port.conv_eligible(module, 16) is eligible
    if eligible:
        assert not port.conv_eligible(module, 17)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.head = nn.Conv2d(3, 16, 3, 1, 1)
        self.body = nn.Sequential(nn.Conv2d(16, 16, 3, 1, 1), nn.ReLU(), nn.Conv2d(16, 16, 3, 1, 1))
        self.tail = nn.Conv2d(16, 3, 3, 1, 1)

    def forward(self, x):
        return self.tail(self.body(self.head(x)))


def test_scope_swaps_and_restores_forwards():
    """Inside the scope the two 16 -> 16 convs are W8A8 and the image-boundary
    convs are not; after it, and after an exception inside it, every module
    has its class's forward again and the parameters never changed."""
    net = _Net().eval()
    x = torch.rand(1, 3, 12, 12)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        ref = net(x)
        with port.quantized_inference(net):
            swapped = [name for name, m in net.named_modules() if 'forward' in m.__dict__]
            out = net(x)
    assert swapped == ['body.0', 'body.2']
    assert not torch.equal(out, ref) and snr_db(ref.numpy(), out.numpy()) > 30
    with pytest.raises(RuntimeError, match='boom'):
        with port.quantized_inference(net, swin_kernels=True):
            assert port.swin_kernels_int8()
            raise RuntimeError('boom')
    assert not port.swin_kernels_int8()
    assert not any('forward' in m.__dict__ for m in net.modules())
    with torch.no_grad():
        assert torch.equal(net(x), ref)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert list(net.state_dict()) == list(before)


def test_nested_scopes_restore_the_swin_flag():
    net = _Net()
    with port.quantized_inference(net, swin_kernels=True):
        with port.quantized_inference(net):
            assert not port.swin_kernels_int8()
        assert port.swin_kernels_int8()
    assert not port.swin_kernels_int8()


def test_static_scales_against_dynamic():
    """Calibrated on the batch it then serves, static tracks dynamic (the
    first conv sees the same absmax in both, the second sees the float
    activation's in one and the int8 one's in the other): above 35 dB; an
    unseen site stays in full precision; a coarser scale costs accuracy; and
    all of it works in inference mode."""
    net = _Net().eval()
    x = torch.rand(2, 3, 12, 12)
    with torch.inference_mode():
        ref = net(x)
        scales = port.calibrate_act_scales(net, net, [x])
        assert sorted(scales) == ['body.0', 'body.2'] and all(v > 0 for v in scales.values())
        with port.quantized_inference(net):
            dynamic = net(x)
        with port.quantized_inference(net, act_scales=scales):
            static = net(x)
        with port.quantized_inference(net, act_scales={'nope': 1.0}):
            unseen = net(x)
        with port.quantized_inference(net, act_scales={'body.0': scales['body.0'] * 4}):
            coarse = net(x)
    assert snr_db(dynamic.numpy(), static.numpy()) > 35
    assert snr_db(ref.numpy(), static.numpy()) > 30 and snr_db(ref.numpy(), dynamic.numpy()) > 30
    assert torch.equal(unseen, ref)
    assert snr_db(ref.numpy(), coarse.numpy()) < snr_db(ref.numpy(), static.numpy())


# ------------------------------------------------------------------ MSRResNet
NET_OPT = dict(num_in_ch=3, num_out_ch=3, num_feat=32, num_block=3, upscale=4)


def _msrresnet_pair(seed=0):
    jnet = JaxMSRResNet(**NET_OPT)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))['params']
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(      # biases away from their zero init
        lambda v: (np.asarray(v) + (0.02 * rng.randn(*v.shape) if v.ndim == 1 else 0))
        .astype(np.float32), jax.device_get(params))
    net = MSRResNet(**NET_OPT).eval()
    net.load_state_dict(jax_params_to_state_dict(params, MSRResNet.JAX_KEY_RULES), strict=True)
    return jnet, params, net


def test_msrresnet_int8_matches_jax_int8():
    """MSRResNet under the W8A8 scope in both packages: each tracks its float
    output above 28 dB (the JAX test's bound), and the two int8 outputs agree
    above 45 dB: they differ by one-step flips of activations, not by the
    scheme."""
    jnet, params, net = _msrresnet_pair()
    x = np.random.RandomState(1).rand(1, 3, 16, 16).astype(np.float32)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    jref = np.asarray(jnet.apply({'params': params}, jx)).transpose(0, 3, 1, 2)
    with jax_quant.quantized_inference():
        jq = np.asarray(jnet.apply({'params': params}, jx)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        ref = net(torch.from_numpy(x)).numpy()
        with port.quantized_inference(net):
            q = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ref, jref, atol=1e-5, rtol=1e-5)
    assert snr_db(ref, q) > 28 and snr_db(jref, jq) > 28
    assert snr_db(jq, q) > 45


@pytest.mark.parametrize('mode', [True, 'static'])
def test_sr_model_val_quant_int8(tmp_path, mode):
    """``val.quant_int8`` routes SRModel's evaluation through the scope in
    both packages, dynamic and static: the port's int8 output is not the
    float one, tracks it above 28 dB, agrees with the JAX model's above
    45 dB, and the network is left with its own forwards."""
    from basicsr4rs_tpu.models import build_model as jax_build_model
    _, _, net = _msrresnet_pair(seed=2)
    ckpt = str(tmp_path / 'net.pth')
    torch.save({'params': net.state_dict()}, ckpt)

    def opt(val, name):
        return {'name': name, 'model_type': 'SRModel', 'scale': 4, 'num_gpu': 0, 'is_train': False,
                'dist': False, 'rank': 0, 'world_size': 1, 'manual_seed': 0,
                'network_g': dict(type='MSRResNet', **NET_OPT),
                'path': {'models': str(tmp_path), 'log': str(tmp_path),
                         'visualization': str(tmp_path), 'pretrain_network_g': ckpt,
                         'strict_load_g': True, 'param_key_g': 'params'},
                'val': val}

    x = np.random.RandomState(3).rand(1, 3, 16, 16).astype(np.float32)
    outs = {}
    for key, val in (('float', {}), ('int8', {'quant_int8': mode})):
        model = build_model(opt(val, f'debug_{key}'))
        model.feed_data({'lq': torch.from_numpy(x)})
        model.test()
        model.test()        # static: the second call reuses the calibrated scales
        outs[key] = model.output.numpy()
        assert not any('forward' in m.__dict__ for m in model.net_g.modules())
    if mode == 'static':
        assert sorted(model._quant_scales)[:2] == ['body.0.conv1', 'body.0.conv2']
    jmodel = jax_build_model(opt({'quant_int8': mode}, 'debug_jax'))
    jmodel.feed_data({'lq': jnp.asarray(x.transpose(0, 2, 3, 1))})
    jmodel.test()
    jout = np.asarray(jmodel.output).transpose(0, 3, 1, 2)
    assert not np.array_equal(outs['int8'], outs['float'])
    assert snr_db(outs['float'], outs['int8']) > 28
    assert snr_db(jout, outs['int8']) > 45


@pytest.mark.parametrize('batched', [True, False])
def test_selfensemble_matches_jax(tmp_path, batched):
    """``test_selfensemble`` (x8 flips and transposes, two batched forwards
    or eight single ones) against the JAX model's on the same weights; 1e-5."""
    from basicsr4rs_tpu.models import build_model as jax_build_model
    _, _, net = _msrresnet_pair(seed=4)
    ckpt = str(tmp_path / 'net.pth')
    torch.save({'params': net.state_dict()}, ckpt)
    opt = {'name': 'debug_tta', 'model_type': 'SRModel', 'scale': 4, 'num_gpu': 0,
           'is_train': False, 'dist': False, 'rank': 0, 'world_size': 1, 'manual_seed': 0,
           'network_g': dict(type='MSRResNet', **NET_OPT),
           'path': {'models': str(tmp_path), 'log': str(tmp_path), 'visualization': str(tmp_path),
                    'pretrain_network_g': ckpt, 'strict_load_g': True, 'param_key_g': 'params'},
           'val': {'selfensemble_batched': batched}}
    x = np.random.RandomState(5).rand(1, 3, 12, 16).astype(np.float32)
    model = build_model(opt)
    model.feed_data({'lq': torch.from_numpy(x)})
    model.test_selfensemble()
    jmodel = jax_build_model(opt)
    jmodel.feed_data({'lq': jnp.asarray(x.transpose(0, 2, 3, 1))})
    jmodel.test_selfensemble()
    assert model.output.shape == (1, 3, 48, 64) and torch.equal(model.lq, torch.from_numpy(x))
    np.testing.assert_allclose(model.output.numpy(),
                               np.asarray(jmodel.output).transpose(0, 3, 1, 2), atol=1e-5)
    model.test()
    assert np.abs(model.output.numpy() - np.asarray(jmodel.output).transpose(0, 3, 1, 2)).max() > 1e-5


# ------------------------------------------------------- the int8 joint block
# (shifted, widths): C=18 in 3 heads of 6 at B=2; the widths the int8 kernel
# takes past the float joint kernel's, at B=1: SwinIR-L's C=240 in 8 heads
# of 30, and C=180 in 3 heads of 60
INT8_CASES = [pytest.param(False, None, id='no_shift'), pytest.param(True, None, id='shift_mask'),
              pytest.param(True, (240, 8), id='C240-8heads'),
              pytest.param(False, (180, 3), id='C180-3heads')]


@pytest.mark.parametrize('shifted, widths', INT8_CASES)
def test_int8_block_against_jax_kernel_and_float_block(shifted, widths):
    """The W8A8 joint block. Against the float block: the JAX test's own
    criterion (SNR > 30 dB, max deviation < 0.1 of the range). Against the
    JAX int8 kernel in interpret mode: by SNR only (> 30 dB, and no further
    from it than from the float block), because the activation scale's tile
    differs: one window here, a row of windows chosen for VMEM there, so the
    two quantise the same values with different scales. The wide blocks'
    weights keep the std a fan-in of C=18 gives 0.2 (0.2 (18 / C)^0.5), as
    in test_torch_swin_block.py's wide cases."""
    if widths is None:
        case, heads, scale = _case(8, shifted, seed=21), HEADS, SCALE
    else:
        c, heads = widths
        case = _case(8, shifted, seed=21, C=c, HIDDEN=2 * c, heads=heads, B=1,
                     wstd=0.2 * (18 / c)**0.5)
        scale = (c // heads)**-0.5
    args = _port_args(case)
    got = port_block.fused_swin_block_full(*args, 8, heads, scale, quant_int8=True).numpy()
    flo = port_block.fused_swin_block_full(*args, 8, heads, scale).numpy()
    assert snr_db(flo, got) > 30
    assert np.abs(got - flo).max() < 0.1 * np.abs(flo).max()
    jgot = np.asarray(jax_block.fused_swin_block_full(*_jax_args(case), 8, heads, scale,
                                                      interpret=True, quant_int8=True))
    assert snr_db(jgot, got) > 30
    assert snr_db(jgot, got) > snr_db(flo, got) - 3


def test_int8_block_tile_is_one_window():
    """The activation scales are per window: changing one window's input
    changes that window's output only, and an outlier in one window does
    not coarsen the others."""
    case = _case(8, False, seed=22)
    args = _port_args(case)
    base = port_block.swin_block_full_int8(*args, 8, HEADS, SCALE)
    args[0] = args[0].clone()
    args[0][:, :8, :8] *= 50.
    moved = port_block.swin_block_full_int8(*args, 8, HEADS, SCALE)
    assert not torch.equal(moved[:, :8, :8], base[:, :8, :8])
    assert torch.equal(moved[:, 8:], base[:, 8:]) and torch.equal(moved[:, :8, 8:], base[:, :8, 8:])


@pytest.mark.parametrize('shifted', [False, True], ids=['no_shift', 'shift_mask'])
def test_int8_block_reports_and_takes_quantised_inputs(shifted):
    """``quantised`` receives the int8 input and the window scales of qkv,
    proj, fc1 and fc2; the plain version given them back repeats its output
    bit for bit and finds the same integers; given one of fc2's integers
    moved by a step, it answers differently at that token only, while its
    own rounding of what it sees still names the unmoved integer."""
    case = _case(8, shifted, seed=25)
    args = _port_args(case) + [8, HEADS, SCALE]
    rec = []
    out = port_block.swin_block_full_int8(*args, quantised=rec)
    b, h, w, c = args[0].shape
    hidden = args[11].shape[0]
    assert [tuple(q.shape) for q, _ in rec] == [(b, h, w, k) for k in (c, c, c, hidden)]
    assert all(q.dtype == torch.int8 and s.shape == (b, h // 8, w // 8) for q, s in rec)
    assert all(int(q.abs().max()) == 127 for q, _ in rec)
    assert torch.equal(out, port_block.swin_block_full_int8(*args))
    again = []
    forced = port_block.reference_swin_block_full_int8(*args, given=rec, quantised=again)
    assert torch.equal(forced, out)
    for (q, s), (q2, s2, r) in zip(rec, again):
        assert torch.equal(q, q2) and torch.equal(s, s2)
        assert torch.equal(torch.clamp(torch.round(r), -127, 127).to(torch.int8), q)
    moved = [(q.clone(), s) for q, s in rec]
    moved[3][0][0, 1, 2, 3] += 1 if moved[3][0][0, 1, 2, 3] < 127 else -1
    again = []
    other = port_block.reference_swin_block_full_int8(*args, given=moved, quantised=again)
    differs = (other != out).any(-1)
    assert differs[0, 1, 2] and differs.sum() == 1
    assert torch.equal(again[3][0], rec[3][0])


def test_int8_block_weights_are_quantised_once_until_they_change():
    case = _case(8, False, seed=23)
    args = [None if t is None else t.clone() for t in _port_args(case)]
    weights = (args[3], args[5], args[11], args[13])
    first = port_block.quantized_block_weights(*weights)
    assert port_block.quantized_block_weights(*weights)[0] is first[0]
    assert first[0].dtype == torch.int8 and first[0].shape == (54, 32) and first[6].shape == (18, 48)
    assert first[0][:, 18:].eq(0).all()
    with torch.no_grad():
        weights[2].mul_(2.)
    second = port_block.quantized_block_weights(*weights)
    assert second[0] is not first[0]
    np.testing.assert_allclose(second[5].numpy(), 2 * first[5].numpy(), rtol=1e-6)
    assert torch.equal(second[4], first[4])


def test_int8_block_binding_matches_the_c_signature(monkeypatch):
    """The int8 block's ctypes types are its kernel's C parameters, one for
    one, for the launch and for its shared-memory query."""
    bound, declared = bound_types(monkeypatch, port_block, 'swin_block_joint_int8_fwd')
    assert bound == declared


@pytest.mark.parametrize('channels, heads', [(272, 8), (144, 2)], ids=['C272', 'head_dim72'])
def test_int8_block_rejects_widths_past_the_register_tiles(channels, heads):
    """The wide variant's register tiles: C <= 256 and heads of at most 64
    features, checked before the weights are quantised or anything is
    built."""
    args = _port_args(_case(8, False, seed=5, C=channels, HIDDEN=2 * channels, heads=heads))
    with pytest.raises(ValueError, match='takes C <= 256 and a head dim <= 64'):
        port_block._launch_joint_int8(*args, 8, heads, (channels // heads)**-.5)


def test_int8_block_has_no_backward():
    args = _port_args(_case(8, False, seed=24))
    args[3].requires_grad_()
    with pytest.raises(NotImplementedError):
        port_block.fused_swin_block_full(*args, 8, HEADS, SCALE, quant_int8=True)
    with pytest.raises(ValueError):
        port_block.fused_swin_block_full(*args, 8, HEADS, SCALE, quant_int8=True,
                                         residual_scales=(torch.ones(2), torch.ones(2)))
    launches = port_block.swin_block_full_int8.launches
    with torch.no_grad():
        port_block.fused_swin_block_full(*args, 8, HEADS, SCALE, quant_int8=True)
    assert port_block.swin_block_full_int8.launches == launches    # a CPU tensor launches nothing


def test_swinir_with_swin_kernels_int8_matches_jax():
    """SwinIR served under ``quantized_inference(swin_kernels=True)`` with
    the convs left in float (``min_channels`` above every width), in both
    packages (the JAX one under ``force_interpret()``, so its blocks run the
    int8 Pallas kernel): each within 30 dB of the float output, the two
    int8 outputs no further apart than that; outside the scope the port is
    float again."""
    config = dict(img_size=16, patch_size=1, in_chans=3, embed_dim=18, depths=(2, 2),
                  num_heads=(3, 3), window_size=8, mlp_ratio=2., upscale=2, img_range=1.,
                  upsampler='pixelshuffle', resi_connection='1conv')
    jnet = jax_swinir.SwinIR(**config)
    rng = np.random.RandomState(6)
    x = rng.rand(1, 3, 16, 16).astype(np.float32)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))['params']
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.randn(*v.shape)).astype(np.float32),
        jax.device_get(params))
    with force_interpret():
        jref = np.asarray(jax.jit(lambda p, v: jnet.apply({'params': p}, v))(params, jx))
        with jax_quant.quantized_inference(min_channels=10**9, swin_kernels=True):
            jq = np.asarray(jax.jit(lambda p, v: jnet.apply({'params': p}, v))(params, jx))
    net = port_swinir.SwinIR(**config).eval()
    net.load_state_dict(jax_params_to_state_dict(params, port_swinir.SwinIR.JAX_KEY_RULES),
                        strict=True)
    calls = []
    real = port_swinir.swin_block_full_int8
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_swinir, 'swin_block_full_int8',
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        ref = net(torch.from_numpy(x)).numpy()
        assert not calls
        with port.quantized_inference(net, min_channels=10**9, swin_kernels=True):
            q = net(torch.from_numpy(x)).numpy()
        assert len(calls) == 4
        again = net(torch.from_numpy(x)).numpy()
    jref, jq = jref.transpose(0, 3, 1, 2), jq.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ref, jref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(again, ref)
    assert snr_db(ref, q) > 30 and snr_db(jref, jq) > 30
    assert snr_db(jq, q) > 30

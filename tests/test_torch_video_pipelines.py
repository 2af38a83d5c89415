"""This slice's configs through the port's entry points on the CPU at a
small width (``num_gpu: 0``): IconVSR trained on the Vimeo90K recurrent set
(``flip_sequence``: 14 frames) with its ``fix_flow`` warm-up and served on the
Vimeo90K test set with ``flip_seq`` and ``center_frame_only``; TOFlow and
DUF served by ``VideoBaseModel``; and the two inference scripts, whose
images equal ``basicsr4rs_torch.test``'s on the same clip and weights."""

import cv2
import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.archs.basicvsr_arch import BasicVSR
from basicsr4rs_torch.archs.basicvsrpp_arch import BasicVSRPlusPlus
from basicsr4rs_torch.inference import inference_basicvsr, inference_basicvsrpp
from basicsr4rs_torch.models.video_base_model import VideoBaseModel
from basicsr4rs_torch.models.video_recurrent_model import VideoRecurrentModel

from test_torch_basicvsr import few_threads  # noqa: F401 (autouse fixture)
from test_torch_video_models import OPTIONS, PP_TEST, run_pipeline, write_clips

ICON_TRAIN = f'{OPTIONS}/train/BasicVSR/train_IconVSR_Vimeo90K_BIx4_synthetic.yml'
ICON_TEST = f'{OPTIONS}/test/BasicVSR/test_IconVSR_Vimeo90K_BIx4_synthetic.yml'
BASICVSR_TEST = f'{OPTIONS}/test/BasicVSR/test_BasicVSR_REDS_synthetic.yml'
TOF_TEST = f'{OPTIONS}/test/TOF/test_TOF_synthetic.yml'
DUF_TEST = f'{OPTIONS}/test/DUF/test_DUF_synthetic.yml'
ICON_SHRINK = ['num_gpu=0', 'network_g:num_feat=8', 'network_g:num_block=1']
SEQS = ['00001/0001', '00002/0001']


def write_vimeo(root, rng):
    """Septuplets of LQ 64x64 (GT 256x256) under ``GT``/``BIx4`` and a
    meta-info file; a 7-frame validation clip under ``val_GT``/``val_LQ``."""
    for seq in SEQS:
        for sub, size in (('GT', 256), ('BIx4', 64)):
            (root / sub / seq).mkdir(parents=True)
            for i in range(1, 8):
                cv2.imwrite(str(root / sub / seq / f'im{i}.png'),
                            (rng.rand(size, size, 3) * 255).astype(np.uint8))
    (root / 'meta.txt').write_text(''.join(f'{seq} 7 (256,256,3)\n' for seq in SEQS))
    write_clips(root, {'val': ({'calendar': 7}, (64, 64))}, rng)


def vimeo_roots(root, phase):
    return [f'datasets:{phase}:dataroot_gt={root / "GT"}',
            f'datasets:{phase}:dataroot_lq={root / "BIx4"}',
            f'datasets:{phase}:meta_info_file={root / "meta.txt"}']


@pytest.fixture(scope='module')
def icon_trained(tmp_path_factory):
    """2 iterations of batch 1 (14 frames a clip), ``fix_flow: 2``."""
    root = tmp_path_factory.mktemp('icon')
    write_vimeo(root, np.random.RandomState(0))
    force = (ICON_SHRINK + vimeo_roots(root, 'train')
             + [f'path:experiments_root={root / "experiments"}', 'train:total_iter=2',
                'train:fix_flow=2', 'datasets:train:batch_size_per_gpu=1',
                'datasets:train:num_worker_per_gpu=1', 'val:val_freq=2',
                'logger:save_checkpoint_freq=2', f'datasets:val:dataroot_gt={root / "val_GT"}',
                f'datasets:val:dataroot_lq={root / "val_LQ"}'])
    return root, run_pipeline(port_train, ICON_TRAIN, root, force, VideoRecurrentModel)


def test_iconvsr_vimeo_train_pipeline(icon_trained):
    root, (model, steps) = icon_trained
    exp = root / 'experiments' / 'train_IconVSR_Vimeo90K_BIx4_synthetic'
    assert [s[0] for s in steps] == [1, 2] and all(np.isfinite(s[2]) for s in steps)
    for _, rates, _ in steps:   # SpyNet's group at an eighth of the rate
        assert len(rates) == 2 and rates[1] == pytest.approx(0.125 * rates[0])
    assert model.metric_results_per_folder['calendar'].shape == (7, 1)
    assert np.isfinite(model.metric_results['psnr'])
    # fix_flow: 2 of the run: SpyNet and the EDVR extractor keep their values in step 1
    frozen = {id(p) for p in model.frozen_parameters(1)}
    names = [k for k, p in model.net_g.named_parameters() if id(p) in frozen]
    assert names and all(k.startswith(('spynet.', 'edvr.')) for k in names)
    assert any(k.startswith('edvr.') for k in names) and model.frozen_parameters(2) == []
    params = torch.load(exp / 'models' / 'net_g_2.pth', weights_only=True)['params']
    assert sorted(params) == sorted(model.net_g.state_dict())


def test_iconvsr_vimeo_test_pipeline(icon_trained):
    """Two septuplets, each 14 frames with ``flip_seq``, the centre frame
    out; the folder's mean over its rows is the mean over the items."""
    root, _ = icon_trained
    ckpt = str(root / 'experiments' / 'train_IconVSR_Vimeo90K_BIx4_synthetic' / 'models' /
               'net_g_2.pth')
    force = (ICON_SHRINK + vimeo_roots(root, 'test_1')
             + [f'path:results_root={root / "results"}', f'path:pretrain_network_g={ckpt}'])
    model, _ = run_pipeline(port_test, ICON_TEST, root, force, VideoRecurrentModel)
    rows = model.metric_results_per_folder['vimeo90k']
    assert rows.shape == (2, 2) and np.all(rows[0] > 0) and np.all(rows[1] == 0)
    assert model.metric_results['psnr'] == pytest.approx(rows[0, 0] / 2, rel=1e-6)
    assert model.output.shape == (1, 3, 256, 256)
    assert len(list((root / 'results').rglob('*.png'))) == 1   # both items write frame 0


def write_frames(folder, frames, size, rng):
    folder.mkdir(parents=True)
    for i in range(frames):
        cv2.imwrite(str(folder / f'{i:08d}.png'), (rng.rand(*size, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize('config, lq_dir, gt, lq, widths', [
    (TOF_TEST, 'BIx4up_direct', (32, 48), (32, 48), {}),
    (DUF_TEST, 'BIx4', (32, 40), (8, 10), {'num_layer': 16}),
], ids=['TOF', 'DUF'])
def test_sliding_window_test_pipelines(tmp_path, config, lq_dir, gt, lq, widths):
    """A clip of 7 frames: 7 windows of 7, one output frame each, on random
    weights saved first."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(1)
    write_frames(tmp_path / 'GT' / 'clip', 7, gt, rng)
    write_frames(tmp_path / lq_dir / 'clip', 7, lq, rng)
    net_opt = dict(yaml_load(config)['network_g'], **widths)
    torch.manual_seed(0)
    torch.save({'params': build_network(net_opt).state_dict()}, tmp_path / 'net.pth')
    force = [f'network_g:{k}={v}' for k, v in widths.items()] + [
                     'num_gpu=0', f'path:results_root={tmp_path / "results"}',
                     f'path:pretrain_network_g={tmp_path / "net.pth"}',
                     f'datasets:test:dataroot_gt={tmp_path / "GT"}',
                     f'datasets:test:dataroot_lq={tmp_path / lq_dir}']
    model, _ = run_pipeline(port_test, config, tmp_path, force, VideoBaseModel)
    rows = model.metric_results_per_folder['clip']
    assert rows.shape[0] == 7 and np.all(np.isfinite(rows)) and np.all(rows[:, 0] > 0)
    assert model.output.shape == (1, 3, *gt)
    assert len(list((tmp_path / 'results').rglob('*.png'))) == 7


@pytest.mark.parametrize('name', ['BasicVSR', 'BasicVSRPP'])
def test_inference_script_gives_the_test_pipeline_images(tmp_path, name):
    """One clip of 3 frames of 64x64: ``inference_<name>`` with the whole
    clip a forward writes the images ``basicsr4rs_torch.test`` writes; in
    chunks of 2 frames, each chunk its own clip."""
    rng = np.random.RandomState(2)
    write_frames(tmp_path / 'GT' / '000', 3, (256, 256), rng)
    write_frames(tmp_path / 'LQ' / '000', 3, (64, 64), rng)
    torch.manual_seed(0)
    if name == 'BasicVSR':
        net, config, script = BasicVSR(8, 1), BASICVSR_TEST, inference_basicvsr
        widths = ['network_g:num_feat=8', 'network_g:num_block=1']
        args = ['--num_feat', '8', '--num_block', '1']
    else:
        net, config, script = BasicVSRPlusPlus(8, 1), PP_TEST, inference_basicvsrpp
        widths = ['network_g:mid_channels=8', 'network_g:num_blocks=1']
        args = ['--mid_channels', '8', '--num_blocks', '1']
    torch.save({'params': net.state_dict()}, tmp_path / 'net.pth')
    force = widths + ['num_gpu=0', f'path:results_root={tmp_path / "results"}',
                      f'path:pretrain_network_g={tmp_path / "net.pth"}',
                      f'datasets:test_1:dataroot_gt={tmp_path / "GT"}',
                      f'datasets:test_1:dataroot_lq={tmp_path / "LQ"}']
    model, _ = run_pipeline(port_test, config, tmp_path, force, VideoRecurrentModel)
    tested = sorted((tmp_path / 'results').rglob('*.png'))
    assert len(tested) == 3
    common = ['--model_path', str(tmp_path / 'net.pth'), '--input', str(tmp_path / 'LQ' / '000'),
              '--device', 'cpu', *args]
    script.main(common + ['--output', str(tmp_path / 'whole'), '--interval', '3'])
    script.main(common + ['--output', str(tmp_path / 'chunks'), '--interval', '2'])
    net.eval()
    clip = torch.from_numpy(np.stack([cv2.imread(str(p))[..., ::-1].transpose(2, 0, 1)
                                      for p in sorted((tmp_path / 'LQ' / '000').iterdir())]))
    clip = clip.float().div(255)[None]
    with torch.no_grad():
        chunks = torch.cat([net(clip[:, :2]), net(clip[:, 2:])], dim=1)[0]
    for i, path in enumerate(tested):
        whole = cv2.imread(str(tmp_path / 'whole' / f'{i:08d}_{name}.png'))
        np.testing.assert_array_equal(whole, cv2.imread(str(path)))
        chunk = cv2.imread(str(tmp_path / 'chunks' / f'{i:08d}_{name}.png'))
        want = (chunks[i].clamp(0, 1).permute(1, 2, 0).numpy()[..., ::-1] * 255).round()
        np.testing.assert_array_equal(chunk, want.astype(np.uint8))
    with pytest.raises(RuntimeError, match='no CUDA device'):   # the card by default
        script.main(['--model_path', str(tmp_path / 'net.pth'), '--input', str(tmp_path / 'LQ'),
                     '--output', str(tmp_path / 'x'), *args])

"""The port's checkpoints and torchvision converter
(``r3det_tpu_torch.utils.checkpoint``), on the CPU.

- ``save_checkpoint`` / ``restore_checkpoint`` round trip: the tiny R3Det
  (depth 10, width 32, 3 classes, 64^2) after two SGD steps on a seeded
  synthetic batch, restored into a model and an optimizer built from
  another seed: every parameter, buffer and momentum tensor bit for bit,
  the update count and the step; a step taken after the restore equals
  the step the saved state takes, bit for bit;
- ``publish_checkpoint`` keeps the state dict alone, under a name suffixed
  with its hash, the same hash for the same tensors;
- ``load_pretrained_backbone`` copies a synthetic torchvision ResNet-50
  into an R50 detector's backbone (the stem folded), leaves the rest, and
  raises on a tensor of another shape; ``load_state_dict_file`` reads
  ``.npz`` and ``torch.save`` files alike;
- the port's copy of ``fold_stem_kernel`` equals the JAX package's.
"""
import copy
import os

import numpy as np
import pytest
import torch

from r3det_tpu.models.resnet import fold_stem_kernel as j_fold
from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.models.resnet import fold_stem_kernel
from r3det_tpu_torch.parallel import train as TR
from r3det_tpu_torch.utils import checkpoint as C
from r3det_tpu_torch.utils.convert import seeded_state_dict

torch.set_num_threads(2)

SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
CFG = T.DetectorConfig(
    num_classes=3, stacked_convs=1, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=T.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(T.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=T.TestCfg(nms_pre=64, max_per_img=16))


def _model(seed):
    model = T.build_detector(CFG, dtype=torch.float32, device='cpu')
    model.load_state_dict(seeded_state_dict(model, seed))
    opt = TR.make_optimizer(model.parameters(), TR.make_lr_schedule(
        warmup_iters=4, iters_per_epoch=10))
    return model, opt, TR.make_train_step(model, CFG, SIZES, optimizer=opt,
                                          device='cpu')


def _batch(seed):
    data = SyntheticDetData(batch_size=2, size=64, max_gt=8, num_classes=3,
                            seed=seed).batch()
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _assert_same_state(a, b, opt_a, opt_b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert len(opt_a.trace) == len(opt_b.trace)
    for ta, tb in zip(opt_a.trace, opt_b.trace):
        assert torch.equal(ta, tb)
    assert opt_a.count == opt_b.count


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The tiny R3Det after two steps, and its checkpoint."""
    model, opt, step = _model(0)
    for i in range(2):
        step(_batch(i))
    path = C.save_checkpoint(str(tmp_path_factory.mktemp('ckpt')), 2,
                             model, opt)
    return model, opt, path


def test_save_restore_is_bit_exact(trained):
    model, opt, path = trained
    assert os.path.basename(path) == 'step_2.pt'
    assert any(float(t.abs().max()) > 0 for t in opt.trace)
    other, other_opt, _ = _model(1)
    assert C.restore_checkpoint(path, other, other_opt) == 2
    _assert_same_state(other, model, other_opt, opt)


def test_restored_state_steps_as_the_saved_one(trained):
    """The next step from the restored state equals the step from the
    state that was saved (the count seeds the schedule and the sampler)."""
    model, opt, path = trained
    ref, ref_opt = copy.deepcopy(model), copy.deepcopy(opt)
    ref_opt.params = list(ref.parameters())
    ref_step = TR.make_train_step(ref, CFG, SIZES, optimizer=ref_opt,
                                  device='cpu')
    other, other_opt, other_step = _model(1)
    C.restore_checkpoint(path, other, other_opt)
    batch = _batch(5)
    want, got = ref_step(batch), other_step(batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_same_state(other, ref, other_opt, ref_opt)
    assert other_opt.count == 3


def test_restore_rejects_another_optimizer(trained):
    model, opt, path = trained
    short = TR.make_optimizer(list(model.parameters())[:-1])
    with pytest.raises(ValueError, match='momentum'):
        C.restore_checkpoint(path, copy.deepcopy(model), short)


def test_publish_strips_the_optimizer_and_hashes_the_name(trained, tmp_path):
    model, _, path = trained
    out = C.publish_checkpoint(path, str(tmp_path / 'r3det_tiny.pt'))
    name = os.path.basename(out)
    assert name.startswith('r3det_tiny-') and name.endswith('.pt')
    assert len(name) == len('r3det_tiny-') + 8 + len('.pt')
    payload = torch.load(out, weights_only=True)
    assert set(payload) == {'state_dict'}
    for k, v in model.state_dict().items():
        assert torch.equal(payload['state_dict'][k], v)
    # the same tensors give the same name
    (tmp_path / 'again').mkdir()
    again = C.publish_checkpoint(path,
                                 str(tmp_path / 'again' / 'r3det_tiny.pt'))
    assert os.path.basename(again) == name


def _resnet50_state_dict(seed):
    """torchvision resnet50 names and shapes, values from a numpy seed."""
    rng = np.random.RandomState(seed)
    sd = {'conv1.weight': rng.normal(0, .1, (64, 3, 7, 7))}

    def bn(k, c):
        sd.update({f'{k}.weight': rng.uniform(.5, 1.5, c),
                   f'{k}.bias': rng.normal(0, .1, c),
                   f'{k}.running_mean': rng.normal(0, .1, c),
                   f'{k}.running_var': rng.uniform(.5, 2, c),
                   f'{k}.num_batches_tracked': np.array(7)})
    bn('bn1', 64)
    inplanes = 64
    for stage, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for b in range(n):
            k = f'layer{stage + 1}.{b}'
            for i, (cin, cout, ks) in enumerate(
                    [(inplanes, f, 1), (f, f, 3), (f, 4 * f, 1)], 1):
                sd[f'{k}.conv{i}.weight'] = rng.normal(
                    0, .05, (cout, cin, ks, ks))
                bn(f'{k}.bn{i}', cout)
            if b == 0:
                sd[f'{k}.downsample.0.weight'] = rng.normal(
                    0, .05, (4 * f, inplanes, 1, 1))
                bn(f'{k}.downsample.1', 4 * f)
            inplanes = 4 * f
    sd['fc.weight'] = rng.normal(0, .01, (1000, 2048))
    sd['fc.bias'] = np.zeros(1000)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            sd.items()}


def test_load_pretrained_backbone_into_r50():
    model = T.build_detector(T.R3DET_R50_V1, dtype=torch.float32,
                             device='cpu')
    model.load_state_dict(seeded_state_dict(model, 0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = _resnet50_state_dict(0)
    C.load_pretrained_backbone(model, sd, depth=50)
    want = C.convert_torch_resnet(sd, 50)
    after = model.state_dict()
    for k, v in after.items():
        if k.startswith('backbone.'):
            assert torch.equal(v, want[k[len('backbone.'):]]), k
        else:
            assert torch.equal(v, before[k]), k
    np.testing.assert_array_equal(
        after['backbone.conv1.kernel'].numpy(),
        fold_stem_kernel(sd['conv1.weight'].numpy().transpose(2, 3, 1, 0)))
    sd['layer2.0.conv2.weight'] = sd['layer2.0.conv2.weight'][:, :, :1]
    with pytest.raises(ValueError, match='layer2_0.conv2.weight'):
        C.load_pretrained_backbone(model, sd, depth=50)


def test_load_state_dict_file_reads_npz_and_torch(tmp_path):
    sd = {'conv1.weight': np.arange(6, dtype=np.float32).reshape(1, 6),
          'bn1.bias': np.ones(3, np.float32)}
    np.savez(tmp_path / 'w.npz', **sd)
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               sd.items()}}, tmp_path / 'w.pth')
    a = C.load_state_dict_file(str(tmp_path / 'w.npz'))
    b = C.load_state_dict_file(str(tmp_path / 'w.pth'))
    assert set(a) == set(b) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(a[k]), sd[k])
        np.testing.assert_array_equal(b[k].numpy(), sd[k])


@pytest.mark.parametrize('shape', [(7, 7, 3, 64), (7, 7, 1, 8)])
def test_fold_stem_kernel_matches_jax(shape):
    w = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(fold_stem_kernel(w), j_fold(w))

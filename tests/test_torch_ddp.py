"""The port's data parallelism on the CPU, against the JAX package and
against the port in one process.

Ranks are subprocesses joined over gloo through a ``file://`` store in
``tmp_path`` (no TCP port, so test workers running side by side cannot
collide), each on one thread, each with a subprocess timeout and a
process-group timeout. One launch of two ranks runs the step, sampler and
eval cases; rank 1 starts from other weights and momentum, which
``broadcast_state`` replaces with rank 0's.

- (a) the tiny f32 R3Det of ``tests/test_torch_train.py`` (depth 10,
  width 32, one refine stage, its perturbed flax weights through
  ``from_flax``) at 128^2, a global batch of 4 split into two local
  batches of 2, two SGD steps on 2 ranks against JAX's ``make_train_step``
  on a one-device mesh over the global batch: losses within 1e-5 and the
  parameters within ``test_torch_train.py``'s 1e-3 of each update;
- (b) the same against the port's single process on the global batch:
  losses within 1e-6 relative and each parameter within 1e-6 of its
  update (only the order of f32 sums differs: two batch-2 gradients
  summed against one batch-4 gradient); the two ranks' parameters, buffers
  and momentum bit-identical after every step;
- (c) a stage with an RRandomSampler: on 2 ranks the sampled masks and the
  losses equal the single process's on the global batch (the masks
  exactly, the losses within 1e-6);
- (d) ``evaluate_dataset`` on 2 ranks over a fake-DOTA split of 7 images
  at batch 3: every image once, equal to the 1-rank port's results
  exactly, and to JAX's within ``test_torch_eval.py``'s tolerances (rtol
  1e-4, atol 1e-3);
- (e) the train CLI and the test CLI on 2 CPU ranks through the launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``--launcher
  pytorch``, a ``file://`` init): rank 0 alone prints, logs and saves,
  the resumed run continues the step and the LR, and the test CLI's
  results on 2 ranks equal those on 1.
"""
import json
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.datasets import dota as JD
from r3det_tpu.models import detectors as J
from r3det_tpu.parallel import mesh as JM
from r3det_tpu.utils.eval_loop import evaluate_dataset as j_evaluate
from r3det_tpu_torch.core import samplers as TS
from r3det_tpu_torch.core import targets as TT
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.parallel import train as TR
from r3det_tpu_torch.tools import make_fake_dota
from r3det_tpu_torch.utils.config import Config as TConfig
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
SIZE = 128
SIZES = ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))
TIMEOUT = 300                     # seconds for one launch of the ranks
LOSS_RTOL = 1e-5                  # against JAX (test_torch_train.py)
STEP_RTOL = 1e-3
SAME_RTOL = 1e-6                  # against the port's single process


def _cfgs(module, sampler=None, loss_cls_type='focal', stacked_convs=1):
    return module.DetectorConfig(
        num_classes=3, stacked_convs=stacked_convs, feat_channels=32,
        backbone_depth=10, num_refine_stages=1, stage_loss_weights=(1.0,),
        s0_train=module.StageTrainCfg(0.5, 0.4, 0.0, 'v1', sampler),
        sr_train=(module.StageTrainCfg(0.6, 0.5, 0.0, None, sampler),),
        loss_cls_type=loss_cls_type,
        test=module.TestCfg(nms_pre=64, max_per_img=16))


J_CFG, T_CFG = _cfgs(J), _cfgs(T)
# (c): the BCE route with an RRandomSampler in both stages
T_SAMPLER_CFG = _cfgs(T, TS.SamplerCfg(num=64, pos_fraction=0.25), 'bce')
# (d): the eval model of test_torch_eval.py
J_EVAL_CFG, T_EVAL_CFG = _cfgs(J, stacked_convs=2), _cfgs(T,
                                                          stacked_convs=2)

WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
rank, ranks, store, job_path, out_path = sys.argv[1:]
rank, ranks = int(rank), int(ranks)
from r3det_tpu_torch.core.targets import anchor_targets
from r3det_tpu_torch.datasets.dota import DOTADataset
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.parallel import dist
from r3det_tpu_torch.parallel import train as TR
from r3det_tpu_torch.utils.convert import seeded_state_dict
from r3det_tpu_torch.utils.eval_loop import evaluate_dataset
group = dist.init_distributed('gloo', 'file://' + store, ranks, rank,
                              timeout_s=120)
job = torch.load(job_path, weights_only=False)


def model(cfg, state):
    m = T.build_detector(cfg, dtype=torch.float32, device='cpu')
    # rank 0's weights reach the other ranks by the broadcast alone
    m.load_state_dict(state if rank == 0 else seeded_state_dict(m, 7))
    return m


def rows(batch):
    b = batch['image'].shape[0] // ranks
    return {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
            for k, v in batch.items()}


out = {}
if 'step' in job:
    j = job['step']
    m = model(j['cfg'], j['state'])
    opt = TR.make_optimizer(m.parameters(), TR.make_lr_schedule(
        base_lr=0.01, warmup_iters=2))
    if rank:
        for t in opt.trace:
            t.fill_(0.5)
        opt.count = 9
    dist.broadcast_state(m, opt, group)
    step = TR.make_train_step(m, j['cfg'], j['sizes'], optimizer=opt,
                              device='cpu', process_group=group)
    batch = rows(j['batch'])
    out['losses'], out['checksums'] = [], []
    for _ in range(2):
        out['losses'].append({k: float(v) for k, v in step(batch).items()})
        out['checksums'].append(dist.checksum(
            list(m.state_dict().values()) + opt.trace))
    out['count'] = opt.count
    out['params'] = {n: p.detach().clone()
                     for n, p in m.named_parameters()}

if 'sampler' in job:
    j = job['sampler']
    m = model(j['cfg'], j['state'])
    dist.broadcast_state(m, None, group)
    batch = rows(j['batch'])
    losses, _ = TR.loss_and_grads(m, j['cfg'], j['sizes'], batch,
                                  torch.Generator().manual_seed(3), group)
    out['sampler_losses'] = {k: float(v) for k, v in losses.items()}
    tgts = anchor_targets(j['anchors'], batch['gt_bboxes'],
                          batch['gt_labels'], batch['gt_mask'],
                          j['cfg'].coder().encode, j['cfg'].num_classes,
                          j['tcfg'], generator=torch.Generator().manual_seed(5),
                          shard=(rank, ranks))
    out['sampler_masks'] = (tgts.bbox_weights, tgts.label_weights)

j = job['eval']
m = model(j['cfg'], j['state'])
dist.broadcast_state(m, None, group)
ds = DOTADataset(*j['split'], filter_empty=False, classes=j['classes'])
out['eval'] = {bs: evaluate_dataset(m, j['cfg'], ds, img_size=64,
                                    batch_size=bs,
                                    process_group=group if ranks > 1
                                    else None)
               for bs in (1, 3)}
torch.save(out, out_path)
'''


def _env():
    return dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT,
                JAX_PLATFORMS='cpu')


def _run_all(cmds, envs, timeout=TIMEOUT):
    """Start every command at once; wait for all of them (killing all on
    a timeout); returns their (stdout, stderr), each rank's exit code 0."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r}:\n{err[-4000:]}'
    return outs


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def make_batch(rng, b, size=SIZE, g=4):
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    gt = np.zeros((b, g, 5), np.float32)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        n = rng.randint(1, g + 1)
        gt[i, :n] = np.stack([
            rng.uniform(20, size - 20, n), rng.uniform(20, size - 20, n),
            rng.uniform(16, 48, n), rng.uniform(12, 32, n),
            rng.uniform(-math.pi / 2 + 0.05, -0.05, n)], -1)
        labels[i, :n] = rng.randint(0, 3, n)
        mask[i, :n] = True
    return dict(image=images, gt_bboxes=gt, gt_labels=labels, gt_mask=mask)


def perturb(tree, rng, path=()):
    """test_torch_train.py's: FrozenBN statistics and affines off the
    identity; the prediction layers scaled up."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if hasattr(v, 'items'):
            out[k] = perturb(v, rng, p)
        elif 'bn' in ''.join(p) and k in ('mean', 'bias'):
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif 'bn' in ''.join(p) and k in ('var', 'scale'):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == 'kernel' and p[-2] in ('retina_cls', 'retina_reg'):
            out[k] = np.asarray(v) * 30
        else:
            out[k] = np.array(v)
    return out


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    """A fake-DOTA split of 8 patches with one annotation file removed:
    7 images, odd, and not a multiple of the batch size 3."""
    root = tmp_path_factory.mktemp('ddp_dota')
    make_fake_dota.main(['--out', str(root / 'raw'), '--split-out',
                         str(root / 'split'), '--num-images', '2'])
    ann = root / 'split' / 'annfiles'
    os.remove(ann / sorted(os.listdir(ann))[-1])
    return str(root / 'split')


@pytest.fixture(scope='module')
def setup(split):
    rng = np.random.RandomState(0)
    batch = make_batch(rng, 2 * RANKS)
    model = J.build_detector(J_CFG, dtype=jnp.float32)
    v = perturb(jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch['image'][:1]))), rng)
    emodel = J.build_detector(J_EVAL_CFG, dtype=jnp.float32)
    ev = jax.tree.map(np.array, jax.jit(emodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    for head in ('bbox_head', 'refine_head_0'):      # test_torch_eval.py's
        ev['params'][head]['retina_cls']['kernel'] *= 100
        ev['params'][head]['retina_reg']['kernel'] *= 30
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        ev['params']['frm_0'][name]['kernel'] *= 30
    ev['params']['refine_head_0']['retina_cls']['bias'] += 4.0
    anchors = torch.cat(T.level_anchors(T_CFG, SIZES), 0)
    tcfg = TT.TargetConfig(sampler=TS.SamplerCfg(num=32, pos_fraction=0.25))
    split_args = (split + '/annfiles/', split + '/images/')
    job = dict(
        step=dict(cfg=T_CFG, sizes=SIZES, state=from_flax(v), batch=batch),
        sampler=dict(cfg=T_SAMPLER_CFG, sizes=SIZES, state=from_flax(v),
                     batch=batch, anchors=anchors, tcfg=tcfg),
        eval=dict(cfg=T_EVAL_CFG, state=from_flax(ev), split=split_args,
                  classes=make_fake_dota.CLASSES))
    return dict(model=model, v=v, emodel=emodel, ev=ev, batch=batch,
                job=job)


def _launch(job, n, d):
    """The outputs of ``n`` ranks running ``job`` (WORKER) in ``d``."""
    path = str(d / 'job.pt')
    torch.save(job, path)
    outs = [str(d / f'rank{r}.pt') for r in range(n)]
    _run_all([[sys.executable, '-c', WORKER, str(r), str(n),
               str(d / 'store'), path, outs[r]] for r in range(n)],
             [_env()] * n)
    return [torch.load(p, weights_only=False) for p in outs]


@pytest.fixture(scope='module')
def ranks(setup, tmp_path_factory):
    """The two ranks' outputs of one launch."""
    return _launch(setup['job'], RANKS, tmp_path_factory.mktemp('ddp2'))


@pytest.fixture(scope='module')
def one_rank(setup, tmp_path_factory):
    """The eval job in one process without a group, set up as a rank is
    (one thread): per image, CPU convolutions round otherwise on another
    thread count and among other batch neighbours."""
    return _launch({'eval': setup['job']['eval']}, 1,
                   tmp_path_factory.mktemp('ddp1'))[0]


def port_model(cfg, state):
    m = T.build_detector(cfg, dtype=torch.float32, device='cpu')
    m.load_state_dict(state, strict=True)
    return m


@pytest.fixture(scope='module')
def single(setup):
    """The port's single process on the global batch: two steps."""
    job = setup['job']['step']
    m = port_model(T_CFG, job['state'])
    opt = TR.make_optimizer(m.parameters(), TR.make_lr_schedule(
        base_lr=0.01, warmup_iters=2))
    step = TR.make_train_step(m, T_CFG, SIZES, optimizer=opt, device='cpu')
    b = {k: t(a) for k, a in setup['batch'].items()}
    losses = [{k: float(v) for k, v in step(b).items()} for _ in range(2)]
    return losses, {n: p.detach().clone() for n, p in m.named_parameters()}


def _assert_params_near(got, want, p0, rtol):
    """Each parameter within ``rtol`` of its update's size (L2) plus two
    f32 ulps of the parameter."""
    for n, w in want.items():
        upd = float((w - p0[n]).norm())
        err = float((got[n] - w).norm())
        assert err <= rtol * upd + 2.0 ** -22 * float(w.norm()), \
            (n, err, upd)


def test_two_ranks_step_the_jax_global_batch(setup, ranks):
    """(a): JAX's make_train_step on a one-device mesh over the global
    batch of 4, two steps."""
    model, v = setup['model'], setup['v']
    tx = JM.make_optimizer(JM.make_lr_schedule(base_lr=0.01,
                                               warmup_iters=2))
    params = jax.tree.map(jnp.asarray, v['params'])
    state = JM.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=v['batch_stats'],
                          opt_state=tx.init(params), tx=tx)
    mesh = JM.make_mesh(jax.devices()[:1])
    jstep = JM.make_train_step(model, J_CFG, SIZES, mesh, donate=False)
    jbatch = {k: jnp.asarray(a) for k, a in setup['batch'].items()}
    for i in range(2):
        state, losses = jstep(state, jbatch)
        for k, w in losses.items():
            got = ranks[0]['losses'][i][k]
            assert abs(got - float(w)) <= LOSS_RTOL * max(abs(float(w)),
                                                          1e-3), (i, k)
    p0 = from_flax({'params': v['params']})
    _assert_params_near(ranks[0]['params'],
                        from_flax({'params': state.params}), p0, STEP_RTOL)


def test_two_ranks_step_the_single_process_global_batch(setup, ranks,
                                                        single):
    """(b): the port's one process on the global batch."""
    want_losses, want = single
    for got, w in zip(ranks[0]['losses'], want_losses):
        assert set(got) == set(w)
        for k in w:
            assert abs(got[k] - w[k]) <= SAME_RTOL * abs(w[k]), (k, got, w)
    p0 = setup['job']['step']['state']
    _assert_params_near(ranks[0]['params'], want, p0, SAME_RTOL)
    assert ranks[0]['count'] == ranks[1]['count'] == 2


def test_ranks_stay_bit_identical(ranks):
    """(b): the state dicts and momentum of both ranks after each step,
    by checksum, and every parameter by torch.equal after the last."""
    for a, b in zip(ranks[0]['checksums'], ranks[1]['checksums']):
        assert torch.equal(a, b)
    assert ranks[0]['checksums'][0].shape[0] > 100
    for n, p in ranks[0]['params'].items():
        assert torch.equal(p, ranks[1]['params'][n]), n
    assert ranks[0]['losses'] == ranks[1]['losses']


def test_sampler_draws_over_the_global_batch(setup, ranks):
    """(c): each rank's sampled masks are its rows of the single
    process's on the global batch, and the losses the single process's."""
    job = setup['job']['sampler']
    b = {k: t(a) for k, a in setup['batch'].items()}
    tgts = TT.anchor_targets(job['anchors'], b['gt_bboxes'],
                             b['gt_labels'], b['gt_mask'],
                             T_SAMPLER_CFG.coder().encode, 3, job['tcfg'],
                             generator=torch.Generator().manual_seed(5))
    assert 0 < int(tgts.bbox_weights.sum()) < int(
        (tgts.assigned_gt >= 0).sum())                # the sampler dropped
    for r, out in enumerate(ranks):
        pos, lw = out['sampler_masks']
        assert torch.equal(pos, tgts.bbox_weights[2 * r:2 * r + 2])
        assert torch.equal(lw, tgts.label_weights[2 * r:2 * r + 2])
    m = port_model(T_SAMPLER_CFG, job['state'])
    want, _ = TR.loss_and_grads(m, T_SAMPLER_CFG, SIZES, b,
                                torch.Generator().manual_seed(3))
    for k, w in want.items():
        got = ranks[0]['sampler_losses'][k]
        assert abs(got - float(w)) <= SAME_RTOL * abs(float(w)), (k, got, w)
    assert ranks[0]['sampler_losses'] == ranks[1]['sampler_losses']


def test_evaluate_dataset_gathers_every_image_once(setup, ranks, one_rank,
                                                  split):
    """(d): 2 ranks, rank 0 with 4 images and rank 1 with 3. At batch 1
    each image runs alone on both sides, and the results equal the 1-rank
    port's exactly; at batch 3 (rank 0's tail batch padded) the batch
    neighbours differ, and they agree within JAX's tolerance. Both batch
    sizes against JAX's loop."""
    args = (split + '/annfiles/', split + '/images/')
    jds = JD.DOTADataset(*args, filter_empty=False,
                         classes=make_fake_dota.CLASSES)
    assert len(jds) == 7
    want = one_rank['eval'][1]
    assert sum(len(c) for r in want for c in r) > 7
    jwant = j_evaluate(setup['ev'], setup['emodel'], J_EVAL_CFG, jds,
                       img_size=64, batch_size=3)
    for out in ranks:
        for bs, got in out['eval'].items():
            assert len(got) == 7 and all(len(r) == 3 for r in got)
            for gi, wi, ji in zip(got, want, jwant):
                for g, w, jw in zip(gi, wi, ji):
                    assert g.dtype == np.float32
                    if bs == 1:
                        assert np.array_equal(g, w)
                    assert g.shape == jw.shape
                    np.testing.assert_allclose(g, jw, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# (e) the CLIs on two CPU ranks
# ---------------------------------------------------------------------------

DEBUG_CONFIG = 'configs/debug/r3det_tiny_fake_dota.py'


def _cli(module, args, store, ranks_=RANKS):
    """``module`` on ``ranks_`` ranks (one process without a group when
    ``ranks_`` is 0): the launcher's environment, gloo over a file
    store. Returns each rank's stdout."""
    if not ranks_:
        cmds = [[sys.executable, '-m', module, *args]]
        return [o for o, _ in _run_all(cmds, [_env()])]
    cmds = [[sys.executable, '-m', module, *args, '--launcher', 'pytorch',
             '--dist-backend', 'gloo', '--dist-url', f'file://{store}']
            for _ in range(ranks_)]
    envs = [dict(_env(), RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(ranks_)) for r in range(ranks_)]
    return [o for o, _ in _run_all(cmds, envs)]


def test_train_and_test_clis_on_two_ranks(split, tmp_path):
    """(e): 2 steps and the eval hook on 2 ranks, resumed to 4; rank 0
    alone prints, logs and saves; the test CLI reads the last checkpoint,
    and its results on 2 ranks equal those on 1."""
    opts = ['--cfg-options', f'data.train.ann_file={split}/annfiles/',
            f'data.train.img_prefix={split}/images/',
            f'data.val.ann_file={split}/annfiles/',
            f'data.val.img_prefix={split}/images/',
            'model.backbone.depth=10', 'model.bbox_head.feat_channels=32',
            'data.samples_per_gpu=1']
    work = tmp_path / 'work'
    common = [DEBUG_CONFIG, '--device', 'cpu', '--img-size', '128',
              '--log-interval', '1', '--work-dir', str(work)]
    outs = _cli('r3det_tpu_torch.tools.train', [*common, '--max-steps', '2', *opts],
                tmp_path / 's1')
    assert 'ranks: 2 over gloo' in outs[0] and 'val mAP @ step 2' in outs[0]
    assert outs[1] == ''
    ckpt = work / 'ckpt' / 'step_2.pt'
    outs = _cli('r3det_tpu_torch.tools.train', [*common, '--max-steps', '4', '--resume-from',
                           str(ckpt), *opts], tmp_path / 's2')
    assert 'resumed from' in outs[0] and outs[1] == ''
    recs = [json.loads(line) for line in
            (work / 'train_log.jsonl').read_text().splitlines()]
    train_recs = [r for r in recs if 'mode' not in r]
    assert [r['step'] for r in train_recs] == [1, 2, 3, 4]
    # the eval hook at each run's end (its interval is 12 epochs); an
    # epoch is 3 steps a rank (7 images, 3 a rank, batch 1)
    assert [r['step'] for r in recs if r.get('mode') == 'val'] == [2, 4]
    cfg = TConfig.fromfile(os.path.join(ROOT, DEBUG_CONFIG))
    sched = TR.make_lr_schedule(
        base_lr=cfg.optimizer.lr, warmup_iters=cfg.lr_config.warmup_iters,
        warmup_ratio=cfg.lr_config.warmup_ratio,
        step_epochs=cfg.lr_config.step, iters_per_epoch=3)
    assert all(math.isfinite(r['total']) for r in train_recs)
    assert [r['lr'] for r in train_recs] == [sched(i) for i in range(1, 5)]
    assert sorted(os.listdir(work / 'ckpt')) == ['step_2.pt', 'step_4.pt']
    last = torch.load(work / 'ckpt' / 'step_4.pt', weights_only=True)
    assert last['count'] == last['step'] == 4

    test = ['r3det_tpu_torch.tools.test', DEBUG_CONFIG,
            str(work / 'ckpt' / 'step_4.pt'), '--device', 'cpu',
            '--img-size', '64', '--batch-size', '1', '--eval', 'mAP',
            '--cfg-options', f'data.test.ann_file={split}/annfiles/',
            f'data.test.img_prefix={split}/images/',
            'model.backbone.depth=10', 'model.bbox_head.feat_channels=32']
    results = []
    for n in (RANKS, 0):
        out = tmp_path / f'results{n}.pkl'
        outs = _cli(test[0], [*test[1:], '--out', str(out)],
                    tmp_path / f't{n}', n)
        assert "{'mAP':" in outs[0] and all(o == '' for o in outs[1:])
        with open(out, 'rb') as f:
            results.append(pickle.load(f))
    assert len(results[0]) == 7
    assert all(np.array_equal(a, b) for ra, rb in zip(*results)
               for a, b in zip(ra, rb))

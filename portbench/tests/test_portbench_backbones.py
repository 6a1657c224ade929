"""The backbone as files of its own: the shipped configurations draw and
count exactly what the harness did before the lookup, and a backbone that
is no ResNet plugs in through new files only."""
import hashlib
import json
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import PB, tiny_config

from portbench.bench import common
from portbench.reference.model import Detector
from portbench.work import flops

# Pinned from the harness before the backbone was looked up by file
# (commit 5664ec0, where ``Detector`` built ResNet itself and
# ``flops.convs`` counted ResNet's convs inline): the sha256 of the names
# and bytes of ``seeded_state`` at the published widths on the CPU, the
# number of state-dict entries and the sha256 of their [name, shape] list
# as JSON, and the forward and train FLOPs of an image at 1024^2.
PARENT = {
    'r3det_r50': (
        'e5edc05d74846c199981e4c40b20535b7781dd95944167e67c508f549a67f389',
        327,
        'a4f751940a5a43815acc6bb101d3b24e5b217ca311b6d5ef5b4732c6bde23a2d',
        669693247488, 1934790230016),
    'rretinanet_obb_r50': (
        '733398e29c8b12664d18f3f85e0325af669bdd81eb3c128f4fbe44915cf06934',
        301,
        'fcfa580eed6060bd87d0563a117d70da37b50ba621fdd37b637f43c32b7a88b7',
        430259175424, 1216488013824),
}
SEED = 3141592653589


@pytest.mark.parametrize('name', sorted(PARENT))
def test_shipped_configs_draw_and_count_as_before(name):
    torch.set_num_threads(2)
    cfg = json.loads((PB / 'configs' / f'{name}.json').read_text())
    assert 'backbone' not in cfg                   # the default: resnet
    ref = Detector(cfg)
    state = common.seeded_state(ref, common.derive_seed(SEED, 1),
                                torch.device('cpu'))
    digest = hashlib.sha256()
    for n, t in state.items():
        digest.update(n.encode())
        digest.update(t.contiguous().numpy().tobytes())
    shapes = [[n, list(t.shape)] for n, t in ref.state_dict().items()]
    want = PARENT[name]
    assert digest.hexdigest() == want[0]
    assert len(shapes) == want[1]
    assert hashlib.sha256(json.dumps(shapes).encode()).hexdigest() == want[2]
    assert flops.forward_flops(cfg, 1024) == want[3]
    assert flops.train_flops(cfg, 1024) == want[4]
    hash(common.program_config(cfg))               # every field hashes


def test_resnet_names_stay_importable_from_the_model():
    from portbench.reference import model
    assert type(Detector(tiny_config('r3det_r50')).backbone) is model.ResNet
    assert model.STAGE_BLOCKS[50] == (3, 4, 6, 3)
    assert model.WIDTHS == (64, 128, 256, 512)


# A transformer-like backbone: patch embeddings by Linear layers, a
# LayerNorm, a 2-D bias table gathered through an integer index buffer,
# and three outputs of unequal channels at strides 8, 16 and 32.
TOY_REFERENCE = '''
import torch
import torch.nn.functional as F
from torch import nn


def build(cfg):
    return Toy(cfg['toy_channels'])


def seed_rule(name, shape):
    if name.startswith('proj_') and name.endswith('.weight'):
        return ('normal', 0.02)
    if name == 'norm.weight':
        return ('fill', 1.0)
    if name == 'table':
        return ('normal', 0.5)
    return None


class Toy(nn.Module):
    def __init__(self, chans):
        super().__init__()
        self.out_channels = tuple(chans)
        cin = 3
        for i, c in enumerate(chans):
            self.add_module(f'proj_{i}', nn.Linear(cin, c))
            cin = c
        self.norm = nn.LayerNorm(chans[0])
        self.table = nn.Parameter(torch.zeros(4, chans[0]))
        self.register_buffer('index', torch.tensor([[3, 1], [0, 2]]))

    def forward(self, images):
        x = F.avg_pool2d(images.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
        outs = []
        for i in range(len(self.out_channels)):
            if i:
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            x = getattr(self, f'proj_{i}')(x)
            if i == 0:
                h, w = x.shape[1:3]
                bias = self.table[self.index].repeat(h // 2, w // 2, 1)
                x = self.norm(x) + bias
            outs.append(x.permute(0, 3, 1, 2))
        return outs
'''

TOY_WORK = '''
import math


def ops(cfg, h, w):
    chans = tuple(cfg['toy_channels'])
    out, cin, s = [], 3, 8
    for i, c in enumerate(chans):
        pos = math.ceil(h / s) * math.ceil(w / s)
        out.append((f'toy.proj_{i}', pos * cin * c, True, i > 0))
        cin, s = c, 2 * s
    return out, chans
'''


@pytest.fixture
def toy(tmp_path):
    for part, src in (('reference', TOY_REFERENCE), ('work', TOY_WORK)):
        d = tmp_path / part / 'backbones'
        d.mkdir(parents=True)
        (d / 'toy.py').write_text(textwrap.dedent(src))
    cfg = dict(tiny_config('r3det_r50'), backbone='toy',
               toy_channels=[16, 24, 40])
    return cfg, tmp_path


def test_a_backbone_plugs_in_through_new_files_only(toy):
    torch.set_num_threads(2)
    cfg, base = toy
    ref = Detector(cfg, base=base)
    assert type(ref.backbone).__name__ == 'Toy'
    neck = ref.neck
    assert [getattr(neck, f'lateral_{i}').in_channels for i in range(3)] \
        == [16, 24, 40]
    assert neck.extra_0.in_channels == 40

    state = common.seeded_state(ref, 5, torch.device('cpu'))
    built = ref.state_dict()
    assert torch.equal(state['backbone.index'], built['backbone.index'])
    assert state['backbone.index'].dtype == torch.int64
    assert torch.equal(state['backbone.norm.weight'], torch.ones(16))
    assert torch.equal(state['backbone.norm.bias'], torch.zeros(16))
    assert torch.equal(state['backbone.proj_2.bias'], torch.zeros(40))
    assert float(state['backbone.proj_2.weight'].std()) == \
        pytest.approx(0.02, rel=0.15)
    assert float(state['backbone.table'].std()) == pytest.approx(0.5,
                                                                 rel=0.3)
    # the shared rule still holds outside the backbone
    assert float(state['bbox_head.cls_conv_0.weight'].std()) == \
        pytest.approx(0.01, rel=0.05)
    again = common.seeded_state(Detector(cfg, base=base), 5,
                                torch.device('cpu'))
    assert all(torch.equal(state[k], again[k]) for k in state)

    ref.load_state_dict(state)
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator()
                    .manual_seed(0))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        out = ref(x)
    sizes = [tuple(c.shape[1:3]) for c in out['s0'][0]]
    assert sizes == list(common.featmap_sizes(cfg, 128))
    assert all(torch.isfinite(t).all() for t in out['sr'][0][0])

    names = [n for n, _, _, _ in flops.convs(cfg, 128, 128, base=base)]
    assert names[:3] == ['toy.proj_0', 'toy.proj_1', 'toy.proj_2']
    assert 'stem' not in names
    # what the reference computed, Linear and conv alike, batch of two
    assert fc.get_total_flops() == 2 * flops.forward_flops(cfg, 128,
                                                           base=base)
    assert flops.train_flops(cfg, 128, base=base) > \
        2 * flops.forward_flops(cfg, 128, base=base)

"""The int8 serving configuration reaches the port's test CLI through
config keys, as it reaches the JAX package's builder.

``tools/test.py --cfg-options model.quantize_int8=static
model.quantize_head_int8=static model.int8_act=True
test_cfg.nms_candidates=2000`` on the R3Det* config builds the same
``DetectorConfig`` (every field, the stage and test configs included) and
passes ``build_detector`` the same kernel flags as
``r3det_tpu/utils/builder.py::build_from_config`` given the same options:
``quantize`` and ``quantize_head`` 'static', ``int8_act`` on, a budget of
2000 NMS candidates with exact top-k. The CLI is stopped once the model
is built.
"""
import os

import pytest

from r3det_tpu.models.detectors import DetectorConfig as JDetectorConfig
from r3det_tpu.utils import builder as JB
from r3det_tpu.utils.config import Config as JConfig
from r3det_tpu_torch.models.detectors import DetectorConfig as TDetectorConfig
from r3det_tpu_torch.tools import test as test_cli
from r3det_tpu_torch.utils import builder as TB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs/r3det/r3det_tiny_r50_fpn_1x_dota_v1.py')
SERVING = ['model.quantize_int8=static', 'model.quantize_head_int8=static',
           'model.int8_act=True', 'test_cfg.nms_candidates=2000']


class Built(Exception):
    pass


def _fields(cfg):
    """A config NamedTuple as nested plain tuples of (field, value). The
    port's ``DetectorConfig`` fields that the JAX package's lacks (the
    backbone choice: ``backbone`` and the ``swin_*`` sizes) must hold their
    defaults, a ResNet's, and are left out."""
    if hasattr(cfg, '_asdict'):
        d = cfg._asdict()
        if type(cfg) is TDetectorConfig:
            for k in set(d) - set(JDetectorConfig._fields):
                assert d.pop(k) == TDetectorConfig._field_defaults[k], k
        return tuple((k, _fields(v)) for k, v in d.items())
    if isinstance(cfg, tuple):
        return tuple(_fields(v) for v in cfg)
    return cfg


def _record(monkeypatch, module, seen):
    def build_detector(cfg, dtype=None, device=None, **kwargs):
        seen.update(cfg=cfg, kwargs=kwargs)
        raise Built
    monkeypatch.setattr(module, 'build_detector', build_detector)


def test_serving_options_build_what_the_jax_builder_builds(monkeypatch):
    port, jax_ = {}, {}
    _record(monkeypatch, TB, port)
    with pytest.raises(Built):
        test_cli.main([CONFIG, '--device', 'cpu', '--cfg-options',
                       *SERVING])
    _record(monkeypatch, JB, jax_)
    cfg = JConfig.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in SERVING))
    with pytest.raises(Built):
        JB.build_from_config(cfg)

    assert _fields(port['cfg']) == _fields(jax_['cfg'])
    assert port['kwargs'] == jax_['kwargs'] == {'int8_act': True}
    det = port['cfg']
    assert det.quantize == det.quantize_head == 'static'
    assert det.test.nms_candidates == 2000 and not det.test.approx_topk
    assert det.num_refine_stages == 1 and det.stacked_convs == 2

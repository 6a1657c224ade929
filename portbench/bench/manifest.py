"""The benchmark's manifest: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name the manifest
gives it; no registry lists them:

- ``configs/<config>.json``: the configuration's sizes (the entry's
  ``file``);
- ``traffic/<traffic>.json``: the mix's parameters, read by the driver
  that its ``mode`` names (``bench/<mode>.py``);
- ``limits/<cell>.json``: the limits of the numbers that decide the
  cell's ``correct``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)`` ->
  a number or None;
- ``reference/backbones/<type>.py`` and ``work/backbones/<type>.py``: the
  backbone that a configuration's ``backbone`` key names (``resnet`` when
  it has none), its plain float32 module and its FLOP count
  (``backbone_file``).
"""
import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                       # the checkout


class Manifest:
    def __init__(self, path=None, base=HERE):
        self.path = Path(path or ROOT / 'BENCHMARK.json')
        self.base = Path(base)
        self.root = self.path.parent
        self.data = json.loads(self.path.read_text())

    def cell(self, name):
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in {self.path}')

    def config_entry(self, name):
        for c in self.data['configs']:
            if c['name'] == name:
                return c
        raise KeyError(f'no config {name!r} in {self.path}')

    def config(self, name):
        return json.loads((self.root / self.config_entry(name)['file'])
                          .read_text())

    def traffic(self, name):
        return json.loads((self.base / 'traffic' / f'{name}.json')
                          .read_text())

    def limits(self, cell):
        p = self.base / 'limits' / f'{cell}.json'
        return json.loads(p.read_text()) if p.exists() else {}

    @staticmethod
    def _applies(metric, cell):
        return cell in metric.get('workloads', [cell])

    def end_to_end(self, cell):
        return [m for m in self.data['end_to_end'] if self._applies(m, cell)]

    def per_layer(self, cell):
        return [m for m in self.data['per_layer'] if self._applies(m, cell)]

    def reader(self, metric):
        """The ``read`` function of ``metrics/<name>.py``."""
        path = self.base / 'metrics' / f"{metric['name']}.py"
        return _load(str(path), 'portbench_metric_'
                     + metric['name'].replace('.', '_')).read


def backbone_file(cfg, part, base=HERE):
    """The module ``<base>/<part>/backbones/<type>.py`` of the
    configuration's backbone type (its ``backbone`` key, else ``resnet``),
    ``part`` being ``reference`` (``build`` and an optional ``seed_rule``)
    or ``work`` (``ops``)."""
    kind = cfg.get('backbone', 'resnet')
    return _load(str(Path(base) / part / 'backbones' / f'{kind}.py'),
                 f'portbench_backbone_{part}_{kind}')


@functools.cache
def _load(path, name):
    """The module at ``path``, executed once a process, so that a
    backbone's classes stay the same objects."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

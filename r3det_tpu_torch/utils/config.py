"""mmcv-style config loader: python dict files, `_base_` inheritance,
dotted-path CLI overrides.

A copy of ``r3det_tpu/utils/config.py`` (stdlib only; the port imports
nothing of the JAX package). It parses the repository's ``configs/``
files unchanged: they are plain Python assigning dicts, lists and scalars.

Merge semantics match mmcv: child dicts deep-merge into base dicts;
a child dict containing `_delete_: True` replaces the base dict wholesale;
non-dict values overwrite.
"""
import ast
import copy
import os.path as osp
import types


class Config:
    """Attribute-style dict wrapper over a merged config namespace."""

    def __init__(self, cfg_dict=None, filename=None):
        object.__setattr__(self, '_cfg', cfg_dict or {})
        object.__setattr__(self, 'filename', filename)

    # -- attribute / item access -------------------------------------
    def __getattr__(self, name):
        try:
            v = self._cfg[name]
        except KeyError:
            raise AttributeError(name)
        return Config(v) if isinstance(v, dict) else v

    def __getitem__(self, name):
        v = self._cfg[name]
        return Config(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        self._cfg[name] = value

    def __setitem__(self, name, value):
        self._cfg[name] = value

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        v = self._cfg.get(name, default)
        return Config(v) if isinstance(v, dict) else v

    def keys(self):
        return self._cfg.keys()

    def items(self):
        return self._cfg.items()

    def to_dict(self):
        return copy.deepcopy(self._cfg)

    def __repr__(self):
        return f'Config({self._cfg!r})'

    # -- loading ------------------------------------------------------
    @staticmethod
    def _exec_pyfile(path):
        with open(path) as f:
            src = f.read()
        mod = types.ModuleType('_cfg_')
        mod.__file__ = path
        code = compile(src, path, 'exec')
        exec(code, mod.__dict__)
        return {k: v for k, v in vars(mod).items()
                if not k.startswith('__') and not isinstance(
                    v, (types.ModuleType, types.FunctionType, type))}

    @staticmethod
    def _merge(base, child):
        """Deep-merge child into base (mmcv semantics)."""
        out = copy.deepcopy(base)
        for k, v in child.items():
            if isinstance(v, dict) and v.get('_delete_', False):
                # don't mutate the caller's dict (it may be shared
                # between two merges of the same base file)
                out[k] = {kk: vv for kk, vv in v.items()
                          if kk != '_delete_'}
            elif (k in out and isinstance(out[k], dict)
                  and isinstance(v, dict)):
                out[k] = Config._merge(out[k], v)
            else:
                out[k] = v
        return out

    @classmethod
    def fromfile(cls, path):
        path = osp.abspath(path)
        ns = cls._exec_pyfile(path)
        bases = ns.pop('_base_', [])
        if isinstance(bases, str):
            bases = [bases]
        merged = {}
        for b in bases:
            base_cfg = cls.fromfile(osp.join(osp.dirname(path), b))
            merged = cls._merge(merged, base_cfg._cfg)
        merged = cls._merge(merged, ns)
        return cls(merged, filename=path)

    # -- CLI overrides -------------------------------------------------
    def merge_from_options(self, options):
        """options: dict of dotted.path -> value (str values parsed as
        python literals when possible). Mirrors --cfg-options."""
        for key, val in (options or {}).items():
            if isinstance(val, str):
                try:
                    val = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    pass
            d = self._cfg
            parts = key.split('.')
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = val
        return self

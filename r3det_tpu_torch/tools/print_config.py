"""Print the merged config and the derived ``DetectorConfig``.

    python -m r3det_tpu_torch.tools.print_config CONFIG [--cfg-options k=v ...]

Port of ``tools/misc/print_config.py``: the same two blocks of text, the
config after ``_base_`` merging and the overrides, then the detector
config the builder derives from its ``model`` dict: the fields its
backbone reads (``derived_fields``).
"""
import argparse
import pprint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Print resolved config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


# the fields that size each backbone
_OWN = {'resnet': ('backbone_depth', 'frozen_stages'), 'swin': ('swin_',),
        'lsknet': ('lsk_',)}


def derived_fields(det_cfg):
    """``det_cfg``'s fields as a dict, less those of the backbones it does
    not build: a ResNet's config leaves out ``backbone`` and the ``swin_*``
    and ``lsk_*`` sizes (so its text is the JAX tool's), a Swin's
    ``backbone_depth``, ``frozen_stages`` and the ``lsk_*`` sizes, an
    LSKNet's those and the ``swin_*`` sizes."""
    others = tuple(p for kind, own in _OWN.items()
                   if kind != det_cfg.backbone for p in own)
    d = det_cfg._asdict()
    return {k: v for k, v in d.items() if not k.startswith(others)
            and not (k == 'backbone' and v == 'resnet')}


def main(argv=None):
    args = parse_args(argv)
    from ..utils.builder import detector_config_from_dict
    from ..utils.config import Config
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    pprint.pprint(cfg.to_dict())
    if 'model' in cfg:
        print('\nDerived DetectorConfig:')
        pprint.pprint(derived_fields(detector_config_from_dict(
            cfg.model.to_dict())))


if __name__ == '__main__':
    main()

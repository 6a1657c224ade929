"""Print the merged config and the derived ``DetectorConfig``.

    python -m r3det_tpu_torch.tools.print_config CONFIG [--cfg-options k=v ...]

Port of ``tools/misc/print_config.py``: the same two blocks of text, the
config after ``_base_`` merging and the overrides, then the detector
config the builder derives from its ``model`` dict.
"""
import argparse
import pprint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Print resolved config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.builder import detector_config_from_dict
    from ..utils.config import Config
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    pprint.pprint(cfg.to_dict())
    if 'model' in cfg:
        print('\nDerived DetectorConfig:')
        pprint.pprint(detector_config_from_dict(
            cfg.model.to_dict())._asdict())


if __name__ == '__main__':
    main()

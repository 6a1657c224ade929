"""ms a predict step in ``models.fpn`` and ``models.retina_head`` (the
base head and every refine head): the sum of their device spans (forward
hooks), averaged over the traced steps."""


def read(run):
    names = [n for n in run['spans']
             if n in ('neck', 'bbox_head') or n.startswith('refine_head_')]
    if not names:
        return None
    return sum(run['spans'][n] for n in names) / run['steps']

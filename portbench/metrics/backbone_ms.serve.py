"""ms a predict step in ``models.resnet`` (the stem, K3, and C2-C5): the
device span between CUDA events at the backbone's entry and exit (forward
hooks), averaged over the traced steps."""


def read(run):
    ms = run['spans'].get('backbone')
    return None if ms is None else ms / run['steps']

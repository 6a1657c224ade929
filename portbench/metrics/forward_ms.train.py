"""ms a train step in the model's forward (``models.*``, bf16): the device
span between CUDA events at the model's entry and exit (forward hooks),
averaged over the traced steps."""


def read(run):
    ms = run['spans'].get('forward')
    return None if ms is None else ms / run['steps']

"""ms a train step in ``parallel.train``'s SGD update by hand (clip,
decay, momentum, about two thousand small launches): the device span
around the optimizer's ``step``, through a delegating wrapper the
benchmark hands to ``make_train_step``, averaged over the traced steps."""


def read(run):
    ms = run['spans'].get('update')
    return None if ms is None else ms / run['steps']

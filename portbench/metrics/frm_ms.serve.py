"""ms a predict step in ``models.frm`` (the FRM's convs and K2): the
device spans of the FRM stages (forward hooks), averaged over the traced
steps. Nothing to read in a detector without refine stages."""


def read(run):
    names = [n for n in run['spans'] if n.startswith('frm_')]
    if not names:
        return None
    return sum(run['spans'][n] for n in names) / run['steps']

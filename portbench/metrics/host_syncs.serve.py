"""Host syncs a predict step: the program's ``r3det.sync.*`` spans (the
NMS budget's live-count read, each fixpoint round's convergence check) in
the program-traced sub-window, over its ``r3det.predict`` spans. Nothing
to read from a program without spans."""
from portbench.bench import program_spans


def read(run):
    tr, steps = program_spans.steps_of(run)
    if not steps:
        return None
    return len(program_spans.ranges(tr, 'r3det.sync.')) / steps

"""Host ms a predict step in syncs and copies: the union of the program's
``r3det.sync.*`` and ``r3det.copy.*`` spans (device-to-host reads in NMS,
the anchors' and the coder's host-to-device copies) in the program-traced
sub-window, over its ``r3det.predict`` spans. Nothing to read from a
program without spans."""
from portbench.bench import program_spans
from portbench.bench.trace import union_length


def read(run):
    tr, steps = program_spans.steps_of(run)
    if not steps:
        return None
    ranges = program_spans.ranges(tr, 'r3det.sync.') \
        + program_spans.ranges(tr, 'r3det.copy.')
    return union_length(ranges) / 1e3 / steps

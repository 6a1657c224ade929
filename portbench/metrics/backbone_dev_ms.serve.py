"""Device ms a predict step launched inside the program's ``r3det.backbone``
spans (the cell's backbone module), in the lean sub-window: the device ops
whose runtime call lies innermost in that span or a span inside it
(``bench/program_timeline.py``). Nothing to read without a card or from a
program without the recorder or the span."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.stage_ms(run, 'device', 'r3det.backbone')

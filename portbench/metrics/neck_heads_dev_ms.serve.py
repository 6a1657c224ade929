"""Device ms a predict step launched inside the program's ``r3det.neck``
and ``r3det.head.*`` spans (``models.fpn`` and every ``models.retina_head``:
the base head and each refine head), in the lean sub-window
(``bench/program_timeline.py``). Nothing to read without a card or from a
program without the recorder or the spans."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.stage_ms(run, 'device', 'r3det.neck',
                                     'r3det.head.')

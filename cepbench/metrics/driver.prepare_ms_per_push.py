"""driver.prepare_ms_per_push: the time in the program's
``driver.prepare`` spans (the block driver's padding, carry, output rows
and argument block, before its launches) in the traced window, in
milliseconds a push."""
from cepbench import program_spans


def read(tr):
    return program_spans.ms_per_push(tr, "driver.prepare")

"""The share of the text tower's rows that hold a prompt: the program's
counters `engine.text_prompts` ÷ `engine.text_rows` (the rows the tower
runs, padded to the engine's batch), %."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return spans.share(p.counter("engine.text_prompts"), p.counter("engine.text_rows")) \
        if p else None

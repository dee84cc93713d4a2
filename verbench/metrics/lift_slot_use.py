"""lift_slot_use.<cell>: the share (%) of the sparse lift's query slots
(batch x cameras x capacity, the program's counter "lift#query_slots")
that held a visible query ("lift#visible_queries"; traced run)."""

from verbench.program_spans import counter


def read(run):
    visible, slots = counter("lift#visible_queries"), \
        counter("lift#query_slots")
    if visible is None or not slots:
        return None
    return 100.0 * visible / slots

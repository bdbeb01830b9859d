"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of their intervals)."""

from portbench.readings import idle_pct


def read(rec):
    return idle_pct(rec)

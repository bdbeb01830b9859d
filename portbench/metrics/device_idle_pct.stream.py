"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of their intervals), over the stream's traced steps.
The same reader as device_idle_pct.library, under the stream's name: one
file could serve both once a benchmark change merges them."""

from portbench.readings import idle_pct


def read(rec):
    return idle_pct(rec)

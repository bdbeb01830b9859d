"""Views (batch x views a step) of every step of the window, over the time
from the window's start to the end of the last step, the data pipeline
running."""

from portbench.readings import views_per_s


def read(rec):
    return views_per_s(rec)

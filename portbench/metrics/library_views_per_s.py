"""Views of every scene the library call answered in the window, over the
time from the window's start to the last answer."""

from portbench.readings import views_per_s


def read(rec):
    return views_per_s(rec)

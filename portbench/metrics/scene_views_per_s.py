"""Views of every answered served request of the window, over the time from
the window's start to the last answer. Padding frames are not counted."""

from portbench.readings import views_per_s


def read(rec):
    return views_per_s(rec)

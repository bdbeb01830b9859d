"""Peak device memory the allocator held during the window (reset at its
start), in GiB."""


def read(rec):
    return rec["peak_window_bytes"] / 2**30 if rec["peak_window_bytes"] else None

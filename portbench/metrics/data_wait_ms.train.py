"""Mean host time a step of the window waited for its batch from the
program's prefetching batch stream."""


def read(rec):
    waits = [r["data_wait_s"] for r in rec["requests"]]
    return 1000.0 * sum(waits) / len(waits) if waits else None

"""Share of the frames the served forwards ran that were shape padding:
(frames run - frames requested) / frames run, over the traced run's
window."""

from portbench.readings import answered


def read(rec):
    fwd = [s for s in rec["spans"] if s["name"] == "forward" and "requested" in s]
    ran = sum(s["frames"] for s in fwd)
    if not ran or not answered(rec):
        return None
    return 100.0 * (ran - sum(s["requested"] for s in fwd)) / ran

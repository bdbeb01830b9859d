"""The attention's share of its roofline in the traced forwards: the least
time of their attention work (flops.attention_bound_s over the requested
frames) over the device time of the attention kernels they launched."""

from portbench.readings import attention_roofline


def read(rec):
    return attention_roofline(rec, "forward")

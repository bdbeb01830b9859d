"""The attention's share of its roofline in the traced training steps: the
least time of each step's attention forward and backward
(flops.attention_bound_s, recomputation not counted) over the device time
of the attention kernels the steps launched."""

from portbench.readings import attention_roofline


def read(rec):
    return attention_roofline(rec, "step")

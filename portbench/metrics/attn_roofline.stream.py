"""The attention's share of its roofline in the traced steps of the stream:
the least time of their attention work (flops_stream.attention_bound_s of
each step: frame, DINOv2 and global attention over the frames cached
before it) over the device time of the attention kernels they launched."""

from portbench.flops_stream import attention_bound_s
from portbench.readings import traced_spans


def read(rec):
    steps = traced_spans(rec, "model.stream_step")
    device = sum(s["attn_s"] for s in steps)
    if not steps or device <= 0:
        return None
    bound = sum(attention_bound_s(rec["arch"], s["counts"]["cached_frames"], *s["hw"])
                for s in steps)
    return 100.0 * bound / device

"""The attention forward's share of its roofline in the traced shard
calls: the least time of the launches' work (``work/attention.py``) over
the device time of the kernels ``attention_kernels.json`` names."""


def read(s):
    if s.get("kind") != "eval" or s["attn_fwd_s"] <= 0.0:
        return None
    return 100.0 * s["attn_fwd_bound_s"] / s["attn_fwd_s"]

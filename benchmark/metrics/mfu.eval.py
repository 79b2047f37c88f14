"""The greedy rollouts' share of the chip's peak: the benchmark's FLOP
count of the traced shard calls' batches (``work/flops.py``, steps up to
each batch's last stop) over the traced window's wall time and the peak
of the cell's compute type."""


def read(s):
    if s.get("kind") != "eval":
        return None
    return 100.0 * s["flops"] / s["window_s"] / s["peak_flops"]

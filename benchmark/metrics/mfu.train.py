"""The update's share of the chip's peak: the benchmark's FLOP count of
the traced updates (``work/flops.py``, steps up to each update's last
stop) over the traced window's wall time and the peak of the cell's
compute type."""


def read(s):
    if s.get("kind") != "train":
        return None
    return 100.0 * s["flops"] / s["window_s"] / s["peak_flops"]

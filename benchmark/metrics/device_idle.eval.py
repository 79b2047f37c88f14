"""The device's idle share of the traced shard calls' window: one less
the union of the device events' intervals over the window's wall time."""


def read(s):
    if s.get("kind") != "eval":
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

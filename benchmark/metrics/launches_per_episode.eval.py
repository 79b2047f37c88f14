"""Device kernels in the traced window per episode evaluated."""


def read(s):
    if s.get("kind") != "eval":
        return None
    return s["launches"] / s["units"]

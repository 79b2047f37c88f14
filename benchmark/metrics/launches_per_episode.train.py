"""Device kernels in the traced window per episode trained."""


def read(s):
    if s.get("kind") != "train":
        return None
    return s["launches"] / s["units"]

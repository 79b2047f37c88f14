"""The host's time to issue one update, ``train_iteration(sync=False)``,
by the harness's own span around each call of the traced window (mean)."""


def read(s):
    if s.get("kind") != "train":
        return None
    return sum(s["host_ms"]) / len(s["host_ms"])

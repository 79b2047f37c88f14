from .metrics import (
    dtw_scores,
    cls_score,
    eval_r2r_item,
    aggregate_metrics,
    IncrementalNDTW,
)

__all__ = [
    "dtw_scores",
    "cls_score",
    "eval_r2r_item",
    "aggregate_metrics",
]

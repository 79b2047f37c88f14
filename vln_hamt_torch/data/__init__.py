from .nav_graph import NavGraph, build_nav_tables
from .feature_db import FeatureDB, HDF5FeatureDB, SyntheticFeatureDB, build_feature_table

__all__ = [
    "NavGraph",
    "build_nav_tables",
    "FeatureDB",
    "HDF5FeatureDB",
    "SyntheticFeatureDB",
    "build_feature_table",
]

from .nav_graph import NavGraph, build_nav_tables
from .feature_db import (FeatureDB, HDF5FeatureDB, SyntheticFeatureDB, build_feature_table,
                         build_object_table, load_obj2viewpoint, load_object_db)

__all__ = [
    "NavGraph",
    "build_nav_tables",
    "FeatureDB",
    "HDF5FeatureDB",
    "SyntheticFeatureDB",
    "build_feature_table",
    "build_object_table",
    "load_obj2viewpoint",
    "load_object_db",
]

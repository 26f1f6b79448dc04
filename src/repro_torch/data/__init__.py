"""Data pipeline: deterministic synthetic shards with per-host slicing."""
from .pipeline import DataConfig, SyntheticLM, make_iterator

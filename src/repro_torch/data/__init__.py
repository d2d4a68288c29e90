"""The port's data pipeline: deterministic synthetic and memmapped token
sources (:mod:`.pipeline`)."""

from .pipeline import BinTokenDataset, DataConfig, SyntheticLM, make_source  # noqa: F401

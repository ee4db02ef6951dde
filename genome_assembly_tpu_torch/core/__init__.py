from .encoding import (
    PAD,
    decode,
    encode,
    encode_batch,
    decode_batch,
)
from .config import AssemblyConfig, ParamBounds, METRIC_NAMES, METRIC_LABELS

__all__ = [
    "PAD",
    "encode",
    "decode",
    "encode_batch",
    "decode_batch",
    "AssemblyConfig",
    "ParamBounds",
    "METRIC_NAMES",
    "METRIC_LABELS",
]

from .encoding import (
    PAD,
    decode,
    encode,
    encode_batch,
    decode_batch,
)
from .config import ParamBounds, METRIC_NAMES, METRIC_LABELS

__all__ = [
    "PAD",
    "encode",
    "decode",
    "encode_batch",
    "decode_batch",
    "ParamBounds",
    "METRIC_NAMES",
    "METRIC_LABELS",
]

"""Checkpoint metadata (counterpart of
paddle_tpu/distributed/checkpoint/metadata.py): the map from each global
tensor to its saved shards, one JSON fragment per writer.

The reference's format, field for field: ``version``, ``extra``, and per
tensor its global shape, its dtype name (numpy's: ``"float32"``,
``"bfloat16"``, ...) and its shards (file, key, global offset, local
shape).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

__all__ = ["ShardMeta", "TensorMeta", "Metadata"]

FORMAT_VERSION = 1


@dataclasses.dataclass
class ShardMeta:
    """One saved shard of a global tensor."""
    file: str                      # data file (relative to the directory)
    key: str                       # key inside the data file
    global_offset: List[int]       # start index per dim in the global tensor
    local_shape: List[int]


@dataclasses.dataclass
class TensorMeta:
    name: str
    global_shape: List[int]
    dtype: str
    shards: List[ShardMeta] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Metadata:
    tensors: Dict[str, TensorMeta] = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    version: int = FORMAT_VERSION

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "extra": self.extra,
            "tensors": {
                name: {
                    "global_shape": tm.global_shape,
                    "dtype": tm.dtype,
                    "shards": [dataclasses.asdict(s) for s in tm.shards],
                } for name, tm in self.tensors.items()
            },
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Metadata":
        blob = json.loads(text)
        md = cls(version=blob.get("version", 0), extra=blob.get("extra", {}))
        for name, t in blob.get("tensors", {}).items():
            md.tensors[name] = TensorMeta(
                name=name, global_shape=list(t["global_shape"]),
                dtype=t["dtype"],
                shards=[ShardMeta(**s) for s in t["shards"]])
        return md

"""Shard-aware checkpointing (counterpart of
paddle_tpu/distributed/checkpoint): each writer saves the pieces it
holds, every element of a global tensor once, with a metadata fragment
mapping each tensor to its shards; a load assembles any region, so a
checkpoint saved under one layout loads under another.  The files are
the reference's (``data_p{i}.npz``, ``metadata_p{i}.json``), and either
package loads the other's.
"""

from .load_state_dict import load_state_dict
from .metadata import Metadata, ShardMeta, TensorMeta
from .save_state_dict import save_state_dict, wait_for_pending_saves

__all__ = ["save_state_dict", "load_state_dict", "Metadata", "TensorMeta",
           "ShardMeta", "wait_for_pending_saves"]

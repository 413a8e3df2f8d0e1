"""Decoder base (counterpart of mindpose_tpu/models/decoders/decoder.py).

Decoders are stateless, hashable frozen dataclasses; ``__call__`` runs on the
device of its inputs.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class Decoder:
    def __call__(self, *args, **kwargs):
        raise NotImplementedError("Decoder must implement __call__.")

"""Retrieval layer, image side: CLIP image tower, embedding codec, flat
vector index files."""
from .clip_model import (CLIPSpec, CLIPVisionTower, port_open_clip_weights,
                         preprocess_image)
from .codec import (ClipCodec, decode_clip_stream, dequantize_clip_u8, l2n,
                    quantize_clip_u8)
from .index import VectorIndex, read_flat_index, write_flat_index

__all__ = [
    "CLIPSpec", "CLIPVisionTower", "port_open_clip_weights", "preprocess_image",
    "ClipCodec", "decode_clip_stream", "dequantize_clip_u8", "l2n",
    "quantize_clip_u8", "VectorIndex", "read_flat_index", "write_flat_index",
]

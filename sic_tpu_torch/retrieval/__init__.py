"""Retrieval layer: CLIP towers and tokenizer, embedding codec, flat vector
index (files and search)."""
from .clip_model import (CLIPModel, CLIPSpec, CLIPTextTower, CLIPVisionTower,
                         SimpleTokenizer, port_open_clip_weights,
                         preprocess_image)
from .codec import (ClipCodec, decode_clip_stream, dequantize_clip_u8, l2n,
                    quantize_clip_u8)
from .index import VectorIndex, read_flat_index, write_flat_index

__all__ = [
    "CLIPModel", "CLIPSpec", "CLIPTextTower", "CLIPVisionTower",
    "SimpleTokenizer", "port_open_clip_weights", "preprocess_image",
    "ClipCodec", "decode_clip_stream", "dequantize_clip_u8", "l2n",
    "quantize_clip_u8", "VectorIndex", "read_flat_index", "write_flat_index",
]

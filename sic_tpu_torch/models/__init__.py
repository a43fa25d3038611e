from .bottleneck import BottleneckCoder, CompressiveBottleneck
from .codec import (Codec, CodecRuntime, EncodeRouter, configure_numerics,
                    get_padding_size, pad_replicate, resolve_device, to_u8)
from .hybrid import FeatMerge, HybridCodec, HybridDecoder, HybridEncoder
from .vqgan import VQGAN

__all__ = ["BottleneckCoder", "CompressiveBottleneck", "Codec", "CodecRuntime",
           "EncodeRouter", "configure_numerics", "get_padding_size",
           "pad_replicate", "resolve_device", "to_u8", "FeatMerge",
           "HybridCodec", "HybridDecoder", "HybridEncoder", "VQGAN"]

from .bottleneck import BottleneckCoder, CompressiveBottleneck
from .codec import Codec, CodecRuntime, configure_numerics, resolve_device, to_u8
from .hybrid import FeatMerge, HybridCodec, HybridDecoder
from .vqgan import VQGAN

__all__ = ["BottleneckCoder", "CompressiveBottleneck", "Codec", "CodecRuntime",
           "configure_numerics", "resolve_device", "to_u8", "FeatMerge",
           "HybridCodec", "HybridDecoder", "VQGAN"]

from .bottleneck import BottleneckCoder, CompressiveBottleneck
from .codec import (Codec, CodecRuntime, EncodeRouter, configure_numerics,
                    get_padding_size, pad_replicate, resolve_device, to_u8)
from .hybrid import FeatMerge, HybridCodec, HybridDecoder, HybridEncoder
from .maskgit import MaskGITGenerator, MaskGITSpec, generate
from .maskgit_vqgan import (MaskGITVQGANSpec, PixelDecoder, PixelEncoder,
                            PixelQuantizer, PixelResnetBlock)
from .titok import (PretrainedTokenizer, TiTok, TiTokDecoderViT,
                    TiTokEncoderViT, inverse_img_stack, make_img_stack)
from .vqgan import VQGAN

__all__ = ["BottleneckCoder", "CompressiveBottleneck", "Codec", "CodecRuntime",
           "EncodeRouter", "configure_numerics", "get_padding_size",
           "pad_replicate", "resolve_device", "to_u8", "FeatMerge",
           "HybridCodec", "HybridDecoder", "HybridEncoder", "VQGAN",
           "MaskGITGenerator", "MaskGITSpec", "generate", "MaskGITVQGANSpec",
           "PixelDecoder", "PixelEncoder", "PixelQuantizer", "PixelResnetBlock",
           "PretrainedTokenizer", "TiTok", "TiTokDecoderViT", "TiTokEncoderViT",
           "inverse_img_stack", "make_img_stack"]

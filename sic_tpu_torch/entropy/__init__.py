from .coder import EntropyCoder, RansDecoder, RansEncoder, pmf_to_quantized_cdf
from .factorized import BitEstimator, Bitparm, FactorizedCoder, factorized_tables
from .gaussian import laplace_bits, laplace_prob
from .huffman import HuffmanCodec, HuffmanCodecOneQP, build_huffman_table
from .tables import GaussianCdfTables, build_gaussian_tables, scale_table
from .torchac_compat import UniformTorchacCodec

__all__ = [
    "EntropyCoder",
    "RansEncoder",
    "RansDecoder",
    "pmf_to_quantized_cdf",
    "BitEstimator",
    "Bitparm",
    "FactorizedCoder",
    "factorized_tables",
    "laplace_bits",
    "laplace_prob",
    "HuffmanCodec",
    "HuffmanCodecOneQP",
    "build_huffman_table",
    "GaussianCdfTables",
    "build_gaussian_tables",
    "scale_table",
    "UniformTorchacCodec",
]

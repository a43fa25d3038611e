from .coder import EntropyCoder, RansDecoder, RansEncoder, pmf_to_quantized_cdf
from .tables import GaussianCdfTables, build_gaussian_tables, scale_table
from .torchac_compat import UniformTorchacCodec

__all__ = [
    "EntropyCoder",
    "RansEncoder",
    "RansDecoder",
    "pmf_to_quantized_cdf",
    "GaussianCdfTables",
    "build_gaussian_tables",
    "scale_table",
    "UniformTorchacCodec",
]

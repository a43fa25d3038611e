from .c2df import pack_c2df, sanitize_enc_result_types, unpack_c2df

__all__ = ["pack_c2df", "unpack_c2df", "sanitize_enc_result_types"]

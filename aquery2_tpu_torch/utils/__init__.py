from aquery2_tpu_torch.utils.misc import (
    CaseInsensitiveDict,
    base62uuid,
    legal_name,
    next_pow2,
)

__all__ = ["CaseInsensitiveDict", "base62uuid", "legal_name", "next_pow2"]

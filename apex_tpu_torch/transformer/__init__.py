"""Attention (the single-device core; sequence parallelism is not ported
yet)."""

from .attention import (MultiheadAttention, dot_product_attention,
                        set_path_hook)

__all__ = ["dot_product_attention", "MultiheadAttention", "set_path_hook"]

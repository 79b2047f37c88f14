from .attention import attention_reference, fused_attention

__all__ = ["attention_reference", "fused_attention"]

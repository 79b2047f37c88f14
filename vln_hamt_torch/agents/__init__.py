from .agent import HAMTAgent

__all__ = ["HAMTAgent"]

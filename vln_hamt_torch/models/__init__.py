from .hamt import HAMT, Critic

__all__ = ["HAMT", "Critic"]

from .agent import HAMTAgent
from .reverie import ReverieAgent
from .variants import CVDNAgent, R2RBackAgent

__all__ = ["HAMTAgent", "R2RBackAgent", "CVDNAgent", "ReverieAgent"]

from .synthetic import SyntheticTokens

__all__ = ["SyntheticTokens"]

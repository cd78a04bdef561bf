from .state import BPEState, BpeConfig, SpecialTokens  # noqa: F401

from .difficulty import calculate_difficulty

__all__ = ["calculate_difficulty"]

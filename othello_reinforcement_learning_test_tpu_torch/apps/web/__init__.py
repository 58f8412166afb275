from .game_manager import GameManager

__all__ = ["GameManager"]

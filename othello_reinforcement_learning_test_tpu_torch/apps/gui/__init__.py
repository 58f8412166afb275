from .app import OthelloApp
from .board_ui import InfoPanel, OthelloBoardUI

__all__ = ["InfoPanel", "OthelloApp", "OthelloBoardUI"]

"""The frontends: the web session layer and server (``web/``) and the Tk
desktop app (``gui/``), on the port's engine, search and players."""

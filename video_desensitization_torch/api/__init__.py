"""Public configuration API (config.ini-compatible)."""

"""The resident frame server."""

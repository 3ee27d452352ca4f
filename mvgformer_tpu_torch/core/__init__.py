"""Core: the serving entry point."""

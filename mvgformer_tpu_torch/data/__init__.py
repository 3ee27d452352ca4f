"""Data layer: batch dataclasses and synthetic scenes."""

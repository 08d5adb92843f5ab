"""Tile-level operations of the port."""

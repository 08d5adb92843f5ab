"""Grid-level (distributed) structures and products of the port."""

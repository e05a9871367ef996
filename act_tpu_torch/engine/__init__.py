"""Weight bridge and serving."""

"""File reading, device resolution and weight import."""

"""Task plugins."""

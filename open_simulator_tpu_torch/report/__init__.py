"""Plain-text report tables for apply results."""

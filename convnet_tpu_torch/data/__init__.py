"""Data constants shared with serving."""

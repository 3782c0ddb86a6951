"""Command-line tools beside the index build."""

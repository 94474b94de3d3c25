"""Join operators."""

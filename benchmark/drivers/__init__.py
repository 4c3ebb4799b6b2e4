"""Drivers, one a traffic kind (`"kind"` of a traffic file)."""

"""Configurations of the port (the §7 detector's constants)."""

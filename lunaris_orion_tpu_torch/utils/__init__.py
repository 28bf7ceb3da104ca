"""Utilities of the port: weight conversion and checkpoint loading."""

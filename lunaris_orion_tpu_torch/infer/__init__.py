"""Inference of the port: checkpoint-driven generation."""

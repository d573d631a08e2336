"""Mesh context of the LM scaffold (``specs.py``): one device for now."""

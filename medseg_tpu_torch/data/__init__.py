"""Packed uint8 datasets and the batch loader."""

"""Evaluation: metrics, the zoo harness and the reference-schema CSV."""

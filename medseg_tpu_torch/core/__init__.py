"""Constants, precision policy, model registry and device resolution."""
